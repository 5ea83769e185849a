"""Drive the PyTorch / CUDA port (``autodist_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises: non-zero exit, no final ``ok`` line):

0. device: requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` reports them, turns TF32 off for float32 products;
1. build: compiles every kernel of the port from ``autodist_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) into the git-ignored ``build/``
   directory, prints the seconds and each kernel's registers and spills
   (``ptxas -v``; a TMA / wgmma kernel must spill nothing), and checks with
   ``cuobjdump -sass`` that every TMA / wgmma instantiation (the forward at
   d = 64 and 128; the backward's dq at d = 64 and 128 and dk/dv at d = 64,
   each with f32 and bf16 outputs) holds HGMMA and UTMALDG instructions;
   meanwhile one child process fills ``build/pycache`` with the bytecode
   of what every later child imports (``PYTHONPYCACHEPREFIX``, also where
   the environment sets ``PYTHONDONTWRITEBYTECODE``);
2. kernels: each kernel against its plain PyTorch version on the card
   (the flash-attention forward, and the backward pair ``flash_bwd_dq`` /
   ``flash_bwd_dkv``), at the serving and training paths' shapes and at
   the causal / offset / ragged / float32 / d = 128 / strided cases, and
   (g) batch x heads past 65535 on every route; every
   call repeated must be bitwise identical, the training variant's bf16 o
   must be its own f32 o cast to bf16, bitwise, every backward case also
   runs with gradients in q's dtype, which must be its f32 gradients cast,
   bitwise, and rows with no visible key give exactly 0; then times each
   kernel (the backward with f32 and with bf16 outputs, each against its
   own bound), its plain version, the
   PyTorch library call that computes the same function (yardstick only,
   never called by the port; its kernels are printed) and the card's
   bound, and times the same way the routes off the main path (bf16
   d = 32 on ``mma.sync``, f32 on FMAs, the dk/dv ``mma.sync`` kernel at
   bf16 d = 128) at one shape each. Times are device time per call from
   ``torch.profiler`` over 20 back-to-back calls, with the host-inclusive
   time per call (CUDA events around 20 calls) beside them;
3. serving: the port's ``serve.Server`` on BERT-base (seeded random
   weights, full width, 12 layers, seq 512) answers concurrent requests
   from four client threads; every answer is held against the port's own
   forward with the plain attention, a repeated request must be bitwise
   identical, every dispatch replays its bucket's CUDA graph, and the
   launch counts show every layer of every dispatch ran the forward kernel;
4. training: BERT-base MLM pretraining (full width and depth, batch 32 x
   seq 128, 20 masked positions, Adam 1e-4, bf16 compute, f32 master
   weights) takes 20 ``Runner.step``s through ``AutoDist(AllReduce())`` on
   a one-rank NCCL world. Step 1 is held against the same step with the
   plain attention; every loss is finite and the last below the first;
   every param changes in step 1; each of the three kernels launches
   exactly 12 x 20 times; a repeated attention backward at a layer's own
   inputs is bitwise identical; one training attention forward launches
   one kernel and nothing else (no cast of o), and its backward each
   backward kernel once and no cast (the kernels write the bf16
   gradients). Prints the median step time, samples/s and a profiled step
   (12 launches of each flash kernel in it; its f32 -> bf16 cast count);
5. the model zoo: ResNet-50 (batch 64 x 224 x 224 x 3, 1000 classes, SGD
   1e-3, ``AutoDist(AllReduce(chunk_size=128))``, the JAX package's
   headline benchmark) takes 20 steps of ``make_callable``'s step, once
   with the model's bf16 compute and once under ``precision="bf16"``;
   step 1 is held against the same model computing in f32, every loss is
   finite and the last below the first, every param changes. Prints the
   median step time, images/s, a profiled step (device-busy share, top
   kernels, layout-transpose kernels), ``flops_estimate()`` and the model
   FLOP/s against the bf16 peak. BiLSTM and NCF at the JAX package's
   default widths take a few steps (finite, falling losses; NCF's four
   tables sparse-access). No flash kernel launches in this phase;
6. decode: lm1b (vocab 32000, width 1024, 16 heads and layers, bf16
   compute, seeded random weights) generates through ``serve.DecodeServer``
   with buckets (8, 256) and (32, 1024), each lane's step one CUDA graph:
   64 requests from four closed-loop clients (prompts of 16-128 tokens,
   32-128 new tokens). Every request completes exactly once with its token
   count; 4 requests' teacher-forced logits are held against the port's
   full-prefix recompute (the count of greedy tokens that agree is
   printed); a reused slot's logits are bitwise those over a zeroed cache;
   each lane's graph replay is bitwise its eager step and its ids
   ``np.argmax`` of its logits; no flash kernel launches on the path; the
   params are unchanged. Prints tokens/s, request p50 / p99, and per lane
   the step's device and host-inclusive ms (graph and eager), its bound,
   and the device-busy share of a window of steps. (The flash kernels at
   batch x heads past 65535, which BERT-base serving reaches at buckets
   over 5461 rows, are phase 2's case (g), on every route.);
7. the host-side step as CUDA graphs: BERT-base MLM (batch 32 x 128, Adam
   1e-4, ``AllReduce()``) from one initial state 20 steps eagerly, 20
   through ``make_callable(batch, aot=True)`` and 20 through
   ``run(..., 20, unroll=4)``; ResNet-50 (batch 64 x 224^2, SGD 1e-3,
   ``AllReduce(chunk_size=128)``) eagerly and through ``aot=True``, with
   the model's bf16 compute and under ``precision="bf16"``. Each graph
   path: step 1's loss bitwise the eager step's, every loss within 1e-2
   relative of the eager path's, its graph captured and replayed once per
   later call (dispatch), and a replay's loss bitwise an eager step's from
   the same state; flash launches 12 x 20 per BERT path (the eager
   warm-up's plus the replays'), 0 for ResNet. Prints the median step
   time, samples (images) / s, model FLOP/s, and the device-busy share of
   5 unprofiled steps, eager and graph. Then serving BERT-base at seq 512,
   buckets (4, 8), phase 3's traffic on bucket graphs: every dispatch's
   answer bitwise the eager forward of its padded batch, every answer
   unchanged after later dispatches, replays == dispatches, flash launches
   12 x (replays + warm-ups); client p50 / p99, and the wall, device time
   and ``Memcpy DtoH`` of a full-bucket request before (eager forward,
   pageable copy) and after (graph replay, pinned fetch);
8. the strategy builders: BERT-base MLM (batch 32 x 128, Adam 1e-4) on a
   one-rank NCCL world from one seeded init, 4 eager steps each under
   ``AutoDist()`` (its default builder, ``PS()``), ``PSLoadBalancing()``,
   ``PartitionedPS()``, ``UnevenPartitionedPS()``, ``PartitionedAR()``,
   ``RandomAxisPartitionAR()`` and ``PS(staleness=2)``, each held to
   ``AllReduce()``'s 4 eager steps (step 1 bitwise, then within
   ``STRATEGY_LOSS_RTOL``), and 20 steps of ``Parallax()`` (BASELINE's
   BERT configuration) through ``make_callable(aot=True)``, held to
   ``AllReduce()``'s aot steps; every run lowers as the JAX package does
   on one device (each variable the replicated update, a stale one the
   local update), with finite falling losses, every param changed, and
   12 launches of each flash kernel a step; each loss tolerance must lie
   between ``AllReduce()`` read again from the same init and at twice the
   learning rate (a planted fault). Prints the Parallax and AllReduce aot
   step times (host-inclusive and device busy). Then the two-rank
   sub-phase: a 2-layer BERT-base-width model (SGD 0.1) under
   ``Parallax()``, ``PartitionedPS()`` and ``PS()`` on two gloo ranks on
   the one card (the split-parameter and ZeRO-1 lowerings beside the
   kernels), losses and each param's update held to one rank's
   ``AllReduce()`` steps (a doubled gradient must read above the update
   tolerance), the ranks' params bitwise equal, and
   ``make_callable(aot=True)`` over the gloo group refused with a
   ``RuntimeError`` naming NCCL (a CUDA graph cannot hold gloo's
   collectives; a graph step never falls back to the eager one);
9. training that survives (``checkpoint/``, ``resilience/``): (a) BERT-base
   (max_len 512, batch 32 x 128, Adam 1e-4, the MLM loss scaled by the
   float masked-LM weights, all 1) takes 12 steps under
   ``CheckpointManager.run(unroll=2)`` (a CUDA graph of 2 steps), a
   checkpoint every 4 steps, ``StepGuard(check_every=2)`` and
   ``AUTODIST_CHAOS=nan_at=5`` set for this part only: exactly one
   rollback, into the graph's own tensors (no new capture), no retained
   step with non-finite params, finite falling losses, the newest step's
   every leaf (Adam's device ``step`` included) bitwise the live state's;
   the checkpoint's bytes and its save / restore ms (host-inclusive,
   GB/s), BERT and ResNet-50; the guard's cost (graph step ms with no
   guard, ``check_every`` 1 and 10). An uninterrupted 16-step graph run
   over distinct batches saves step 8; (d) its newest step truncated,
   ``restore_or_init`` in a fresh Runner falls back to step 8 (every leaf
   bitwise) and resumes to 16: losses and the update held to the
   uninterrupted run, each tolerance between the same run again (floor)
   and a resume with Adam's moments zeroed (planted fault), all printed;
   (b) the same for ResNet-50 (64 x 224^2, SGD 1e-3), bitwise; (c) a child
   process (this script) trains BERT-base eagerly under
   ``CheckpointManager.run(preemption=True)``, takes a real SIGTERM, saves
   its emergency step 4 and exits with 128 + 15; this process resumes from
   it for 4 more steps; (e) the params restored from the checkpoint serve
   through ``serve.Server`` (bucket 8 x 512), bitwise the trained params'
   eager forward; (f) the graph step around an asynchronous
   ``CheckpointManager.save`` (the save call, the graphs after it,
   ``wait_until_finished``) beside a synchronous ``Saver.save``, the saved
   step bitwise the state at the save. Flash launches: 12 a layer's step
   on every BERT path;
10. sequence parallelism: (a) in one process, a causal ring of 4 hops of
   4096 over a global sequence of 16384 at lm1b's attention width (b 2,
   h 16, d 64, bf16): every hop's ``block_attn_fwd`` / ``block_attn_bwd``
   against its plain version (wholly masked hops exactly o = 0, lse =
   -1e30, gradients 0), the ring's o, dq, dk and dv against one
   ``flash_attention`` call over the whole sequence (the tolerance between
   the ring's reading and a dropped hop's), and the hop kernels timed at
   the diagonal and at a fully visible hop beside their plain versions,
   SDPA (causal / non-causal) and the bound; (b) two gloo ranks on the
   card train an LM at lm1b's widths (2 layers, max_len 4096, batch 2 x
   4096, SGD 0.1) under ``SequenceParallel("ring")`` and ``("ulysses")``
   through ``AutoDist`` -> ``Runner.step``, each rank its half of the
   sequence: losses and the update held to one rank's ``AllReduce()``
   steps over the whole sequence, each tolerance between that run again
   and a block-diagonal fault, the ranks' params bitwise equal, and each
   layer's launches of the hop and flash kernels counted;
11. tensor parallelism: (a) two gloo ranks on the card (processes of this
   script) train BERT-base at full width and 3 of its 12 layers
   (``GLOO_BERT_LAYERS``; vocab 30522, dim 768, 12 heads, max_len 512,
   bf16 compute) on the MLM batch (32 x
   128, 20 masked positions, SGD 0.1, 4 eager steps) under
   ``ModelParallel(AllReduce(), model_axis=2)`` and ``ModelParallel(PS())``
   on ``{data: 1, model: 2}``, each rank running the flash kernels on its
   6 heads: losses and each run's update held to one rank's
   ``AllReduce()`` steps from the same seeded init, each tolerance
   between the floor (that run again) and the planted faults (the
   gathered gradient left undivided, the copy-to-model backward
   all-reduce dropped), the replicated parameters bitwise equal across
   the ranks and the pieces not, 12 launches of each flash kernel a step
   on each rank; (b) prints each rank's stored parameter bytes against
   the whole model's, its peak memory, the step ms, the model group's
   activation all-reduce and embedding gather ms, and the three flash
   kernels at b32 h6 s128 d64 against their plain versions, SDPA and the
   bound (device and host-inclusive ms); (c) the ``AllReduce`` run's
   ``CheckpointManager`` step restores into a one-rank Runner, every leaf
   bitwise the TP world's logical params, and the restored params serve
   through ``serve.Server`` (bucket 8 x 512) bitwise that Runner's eager
   forward; (d) the phase's seconds;
12. expert parallelism: one MoE layer (``parallel/moe.py``) at
   Switch-Base-8's widths (d_model 768, d_ff 3072, 8 experts, top-2,
   capacity factor 1.25, bf16 compute) -> a 4-class head, cross-entropy +
   0.01 aux, on x of 32 x 128 x 768 (4096 tokens, capacity 1280), SGD 0.1,
   4 steps: (a) one rank eagerly, again (the floor) and through
   ``make_callable(aot=True)`` (the dispatch holds no host sync, or the
   capture fails): the graph's losses within the floor of the eager ones,
   ``flops_estimate`` covering the expert products; (b) two gloo ranks on
   the card (processes of this script) under ``ModelParallel(AllReduce(),
   model_axis=2, rules=moe.EXPERT_RULES, mesh_axis="expert")`` and over
   ``PS()`` on ``{data: 1, expert: 2}``, each rank storing and computing 4
   of the 8 experts: losses and each param's update held to one rank's
   steps, each tolerance between the floor and the planted faults (the
   copy-to-expert backward dropped, the aux gradient summed over the
   expert group, the gathered gate gradient undivided), the replicated
   parameters bitwise equal across the ranks and the pieces not, the
   top-k indices equal across the group at every step, every expert
   product of a rank on 4 experts; (c) prints the stored parameter bytes
   and peak memory a rank, the step ms (one rank eager / graph, EP rank),
   the expert FFN's device ms at 8 and 4 experts against its bound, and
   the expert group's all-reduce of the (T, d) f32 output; (d) the
   AllReduce run's ``CheckpointManager`` step restores into a one-rank
   Runner, every leaf bitwise the EP world's logical params, and that
   Runner's forward gives the EP step's loss; (e) the phase's seconds;
13. pipeline parallelism: lm1b at full width (vocab 32000, dim 1024, 16
   heads of 64, 4 of its 16 layers, bf16 compute) in the stacked layout
   (``scan_layers=True``), batch 8 x 1024, SGD 0.1, 3 steps: (a) one rank
   eagerly, again (the floor), through ``make_callable(aot=True)`` (losses
   bitwise the eager ones) and with the same weights unstacked; (b) two
   gloo ranks on the card (processes of this script) under
   ``Pipeline(num_stages=2, num_microbatches=4)`` on ``{data: 1, pipe:
   2}``, each rank storing and running 2 layers, under ``shift``,
   ``shift`` again, ``sequential`` and ``1f1b``: losses and the update
   held to (a) between the floor and two planted faults (the whole
   gradients not summed over the pipe group; the head counted on every
   rank), ``sequential`` and ``1f1b`` within the pipelined floor of
   ``shift``, the whole parameters bitwise equal across the ranks; prints
   each rank's stored parameter bytes, peak memory per schedule, step ms,
   the pipe hop's and the output broadcast's ms through gloo; (c) each
   rank's flash launches a step: its layers x microbatches (the forward
   twice under ``1f1b``); (d) the ``shift`` run's checkpoint restores on
   one rank, every leaf bitwise, its next step's loss the pipelined one's;
   (e) the phase's seconds;
14. BERT's MLM under a seq axis: BERT-base at full width and 3 of its 12
   layers (``GLOO_BERT_LAYERS``; MLM
   32 x 128, 20 masked positions a row, SGD 0.1, 3 eager steps) on one
   rank twice (the floor), then (a) two gloo ranks on the card under
   ``SequenceParallel("ring")`` on ``{data: 1, seq: 2}`` and (b) four
   under ``ModelParallel(SequenceParallel(ring | ulysses, 2), 2)`` on
   ``{data: 1, seq: 2, model: 2}`` (6 heads and a 64-row chunk a rank):
   losses and the whole update held to one rank's between the floor and
   the planted faults (each rank's attention local to its chunk; the
   gathered embedding gradient undivided), the whole parameters bitwise
   equal on every rank, the pieces one per model index, every flash and
   hop function launched as counted from the code a rank and step;
   prints each rank's stored parameter bytes, peak memory, step ms and
   the seq hop's and the model all-reduce's ms through gloo; (c) the hop
   functions at this path's hop shape and the flash kernels at Ulysses'
   shape under TP against their plain versions, timed beside them, SDPA
   and the bound; (d) the phase's seconds;
15. pipeline x sequence parallelism: phase 13's LM and batch on four
   gloo ranks under ``SequenceParallel("ring", 2, base=Pipeline(2, 4))``
   on ``{data: 1, pipe: 2, seq: 2}`` (2 layers and a 512-row chunk a
   rank) under ``shift`` and ``1f1b``, and ``shift`` with the pipe hop
   sent to the next stage's rank of the other chunk (the planted fault):
   held to phase 13's one-rank steps between its floor and the fault,
   ``1f1b`` bitwise ``shift``, launches counted a rank and step; prints
   stored bytes, peak memory per schedule, step ms, the seq and pipe
   hops' and the output broadcast's ms; (c) the hop functions at this
   ring's diagonal and visible hops against their plain versions, timed;
17. two piece axes (a variable split over two mesh axes, from a fixed
   builder, ``TwoAxis``: no builder composes them): (a) phase 13's LM
   and batch on four gloo ranks under ``Pipeline(2, 4)`` with every
   stacked Megatron weight and the embedding split over ``model`` too
   (``{data: 1, pipe: 2, model: 2}``: 2 layers, 8 heads and 2048 MLP
   columns a rank) under ``shift`` and ``1f1b``, held to phase 13's
   one-rank steps between its floor and two planted faults (the
   copy-to-model backward without its all-reduce; the gradients pipe
   does not split averaged over pipe instead of summed), ``1f1b``
   bitwise ``shift``, 8 flash launches of each kernel a rank and step
   (16 forwards under ``1f1b``); (b) phase 12's MoE layer with ``up`` /
   ``down`` split over ``expert`` and ``model`` (4 experts x 1536 columns
   a rank), held to phase 12's one-rank steps between its floor and the
   fault (the partial output summed over the expert group alone), the
   expert FFN timed at a rank's shape; each prints stored bytes, peak
   memory, step ms and its groups' collective ms; (c) the flash kernels
   at (a)'s rank shape (b2 h8 s1024 d64, causal) against their plain
   versions, timed beside SDPA and the bound; (d) (a)'s checkpoint
   restores on one rank bitwise;
18. the input pipeline (``data/``): (a) BERT-base MLM (32 x 128, 20
   masked positions packed into one int32 record of 296 values, Adam
   1e-4) 40 steps of ``Runner.run(loader, 40, unroll=4)`` over a
   ``NativeDataLoader`` of 256 records (the native backend: the wired
   ``BlockStacker`` -> ``DevicePrefetcher(shard_block)`` -> megastep
   graph, the blocks stacked in pinned buffers and reaching the copy with
   no ``pin_memory()`` call) and over a plain iterator of a second loader
   of the same seed (the host-stacked path): step 1 bitwise, every loss
   within phase 7's tolerance, 12 x 40 launches of each flash kernel a
   path; prints both paths' steady ms per step with their spread; (b)
   ResNet-50 at 64 x 224^2 from uint8 records (4 x 64 images,
   normalized on the card in the loss): the wire alone, the wire behind
   synchronous assembly, assembly alone, and the loader-fed
   ``make_callable(aot=True)`` step through ``DevicePrefetcher(loader=)``
   in turns with the same step on a placed batch (images/s, data wait),
   no pool allocation after warm-up; (c) 32 batches of (b) with the
   loader's ring on and depth 3, each copy held back 20 ms: every batch's
   device checksum equals its host checksum, and recycling a staging
   buffer at settle (the planted fault) must mismatch; (d) the phase's
   seconds;
19. per-scope program costs (``GraphItem.op_provenance`` / ``scope_costs``
   / ``activation_live_bytes`` and the stage cutter): (a) BERT-base (phase
   4's MLM batch, 32 x 128, bf16) and lm1b (phase 13's, stacked, 8 x
   1024): ``top_level_costs`` and ``cut_stages(item, 4)``, the stages'
   FLOPs summing exactly to ``flops_estimate()``, lm1b's cut four
   ``blocks[i]`` a stage at imbalance 0, each model's three largest scopes
   by FLOPs and by bytes; (b) each model's forward under ``no_grad`` on
   the card through the attention's plain version (the program the trace
   describes): its peak allocated bytes above the allocation before it
   against ``activation_live_bytes()``, within COST_LIVE_RTOL, which must
   lie between a second forward's reading (the floor) and a scan that
   never frees (the planted fault: the sum of every op's outputs); the
   flash path's peak beside it, and the gap against the (b, h, s, s)
   scores the kernel never writes; (c) four gloo ranks of the card
   (processes of this script) build ``Pipeline()`` with no arguments on a
   spec of four devices: ``resolve_stages`` gives (4, "auto"),
   ``resolve_microbatches`` 8, the proto that of ``Pipeline(4, 8)``; then
   3 SGD 0.1 steps of lm1b on ``{data: 1, pipe: 4}``, held to phase 13's
   one-rank steps between its floor and the planted fault (the whole
   gradients not summed over the pipe group), the ranks' whole params
   bitwise equal, 32 launches of each flash kernel a rank and step;
   prints the cut, stored bytes and peak a rank, and the step ms, and,
   after two more ``Runner.run`` steps, rank 0's gathered telemetry
   snapshots (one a rank) and the ``pipeline.*`` gauges; (d) the phase's
   seconds;
20. in-process observability on BERT-base MLM training (32 x 128, bf16
   compute, Adam 1e-4, ``AllReduce()``, a ``NativeDataLoader`` of phase
   18's records): (a) ``CheckpointManager.run`` for OBS_STEPS steps under
   ``unroll=4`` with a save every 20 steps, telemetry on, then the same
   run with ``AUTODIST_TELEMETRY=0`` in the same process (both under
   ``torch.use_deterministic_algorithms``, which makes the embedding
   gradient's scatter deterministic): the params bitwise equal, the flash
   launches equal (12 x OBS_STEPS each), the flushed Chrome trace holds
   ``capture``, ``strategy-build``, ``transform``, ``compile``,
   ``step-loop`` and ``checkpoint-save``, and the telemetry-off run writes
   no trace, flight, goodput or calibration file; (b) ``Runner.run(
   unroll=4)`` (its capture in a first run fed by the loader) on
   device-resident batches: the attribution's components sum to
   ``wall_ms``, and ``wall_ms`` agrees with the graph step timed by CUDA
   events here within OBS_WALL_RTOL, which lies above the floor (two such
   timings) and below the planted fault (the loop's clock on the host
   with no event, which times the enqueue); the steady step with
   telemetry on and off; a loader-fed run's wall and data wait, printed;
   (c) the goodput ledger's ``hfu`` (model FLOPs over productive step
   time at 989 TFLOP/s) against the same ratio from (b)'s timing, within
   OBS_MFU_RTOL; (d) ``AUTODIST_TRACE=profiler``: every
   flash kernel of a ``Runner.run`` in the ``torch.profiler`` trace
   written to ``DEFAULT_TRACE_DIR`` launched inside its ``step-loop``
   range (profiled again while the trace lacks some of the launches);
   (e) ``AUTODIST_CHAOS=oom_at`` writes ``oom_report.json`` and an
   ``oom`` flight event and still raises, and ``memory.is_oom`` is true
   for a real ``torch.OutOfMemoryError`` from an allocation above the
   card's capacity; (f) the phase's seconds. (a) also runs telemetry on a
   second time: each on-run's goodput must read above 0 and agree with
   the phase's own figure (the CUDA-event dispatch intervals less the
   data wait, the host-timed save stalls before the last dispatch and the
   capture) within OBS_GOODPUT_RTOL, above the floor (the two runs'
   ratios) and below the planted fault (the old arithmetic, which took
   every in-loop save off the billed steps);
21. the rest of the in-process observability: (a) BERT-base serving at
   seq 512 (buckets 4 and 8, bf16 compute, OBS21_REQUESTS requests of
   1-8 rows from 4 client threads, no coalescing wait,
   ``AUTODIST_SERVE_SLO_MS=50``), telemetry on then off in one process:
   answers bitwise equal, ``serve.requests`` and the ``serve.latency_ms``
   count = the requests with p50 / p99 = ``Server.stats()``'s,
   ``serve.batches`` = the replica's dispatches, ``serve.padded_rows`` =
   the dispatch log's padding, ``serve.slo_burn`` = p99 / 50, one
   ``serve-aot-compile`` span and ``serve-compile`` event a bucket, 12
   flash launches a dispatch, and nothing recorded with telemetry off;
   (b) a bucket the ledger's own prediction puts above capacity x
   headroom is refused by name (``InfeasibleMemoryError``) with
   ``torch.cuda.memory_allocated`` unchanged and no capture span; each
   real bucket's predicted peak beside the allocator's peak over a
   dispatch; the same for lm1b's ``DecodeServer`` (a planted lane whose KV
   cache alone exceeds the limit), whose real lane then decodes
   OBS21_DECODE_TOKENS tokens for each of OBS21_DECODE_REQUESTS requests
   (``decode.tokens``, ``decode.latency_ms``); (c) BERT-base MLM (32 x
   128) through an eager ``Runner.run`` of OBS21_PROFILED steps under
   ``AUTODIST_TRACE=profiler``: the profile's compute source is
   ``torch-profiler``, its rows sum to ``attr.device_compute_ms``, the
   attributed + unattributed kernel time is the trace's, and every flash
   launch (forward and both backward kernels) lands in a
   ``layer{i}/attn`` row, which the same trace attributed without the
   backward linking must fail; then ``unroll=4`` runs, their source
   printed; (d) two gloo ranks of this script (``--obs-skew``) train
   BERT-base MLM on ``{data: 2}`` twice, rank 1's data iterator sleeping
   in the second run, rank 0 serving the monitor: the clock offset within
   its uncertainty, a planted clock shift read back, both rings on the
   same dispatch indices, ``wire + skew_wait == exposed_comms`` per rank
   and window, rank 1 labelled input-bound by ``cluster.aggregate`` and
   its input-bound flip raised once (a flight event), ``/metrics`` and
   ``/status`` parsed, ``stop()`` freeing the port, 12 launches a step of
   each flash kernel on each rank; (e) the phase's seconds;
22. the transform report, the step's op text and the merged timeline,
   on BERT-base MLM (32 x 128, Adam 1e-4, ``Runner.run(unroll=4)``, the
   graph capture auto-rendering the page; 12 x 4 launches of each flash
   kernel): (a) ``write_report`` and
   ``dump_compiled``: the page equal to its ``report.html`` alias, its
   variable count and bytes those of ``graph_item.variables``, its
   attribution, goodput and memory figures the ledgers' at the page's
   rounding, the state (params, Adam state, step, the graph's static
   buffers) bitwise unchanged and the flash ``launches`` unmoved, the
   step text with 12 lines of each flash kernel and equal to the text of
   the same program on the CPU; (b) in phase 21 (d)'s ranks, rank 0
   alone writes the step text and the report while rank 1 waits at a
   barrier: the gradient sync's all-reduces number ``bucket_plan()`` and
   the loss's mean is the one other (a count off by one must fail the
   check); (c) ``tools/timeline.py`` merges the two ranks' directory:
   every span of both traces exactly once, the ranks' matched ``sync``
   spans aligned, and again with rank 1's clock planted 25 ms ahead and
   corrected by the ping's estimate of it (aligned within the estimate's
   uncertainty plus 1 ms of barrier exit spread; with the offset zeroed
   they sit ~25 ms apart and the check must fail); render, write_report,
   dump_compiled and merge times beside the card line; (d) the phase's
   seconds;
23. the multi-process runtime: (a) a ``launch: local`` spec (coordinator
   on a free localhost port, nodes ``proc0`` (chief) and ``proc1``, both
   ``gpus: [0]``, so gloo: two ranks share the card) starts a two-process
   BERT-base MLM job (full width and depth, 32 x 128, 16 rows a rank,
   bf16 compute, Adam 1e-4, ``AllReduce()``, deterministic algorithms)
   under ``AUTODIST_SUPERVISION=elastic`` and ``AUTODIST_CHAOS=
   kill_at=3:1``: this script, run as ``--elastic-train``, is the user
   script the Coordinator re-runs. Generation 0 trains steps 1-3 through
   ``CheckpointManager(save_interval_steps=2).run(coordinator=...)``; the
   worker hard-exits (code 9) after step 3; the chief's ElasticPolicy
   re-execs the script at world size 1; generation 1 reshard-restores step
   2 (2 -> 1 processes) onto a one-rank NCCL world and runs to step 12
   with ``unroll=4`` (single steps 2 -> 4, the megastep 4 -> 8 that
   captures the CUDA graph, and 8 -> 12 replaying it) with no save. The
   event trail (the flight files) holds worker-death, re-form-request,
   re-form, spec-shrink, reshard and the (skipped) emergency-save; (b) a
   clean one-process resume from the same checkpoints (its own one-node
   spec, started beside (a), reading the checkpoints once generation 0
   has re-exec'd) over the same steps: its params bitwise equal (a); (c) the
   stitched goodput ledger: generations [0, 1], a re-exec gap and a
   reshard above 0, 3 + 10 steps (step 3 ran in both generations),
   goodput and the classes within 5% / 1 ms of the wall, 0 < MFU <= 1,
   the chief's report page "stitched across generations" with the re-exec
   gap bar, and a segment directory without generation 1 not stitched;
   prints each generation's wall, the gap, the restore and reshard ms, the
   classes, each kernel's launches a generation and rank (12 a step) and
   the phase's seconds;
24. the other gradient-sync kinds: (a) the wire functions on the card
   against their CPU results (the int8 quantization's q and scales
   bitwise, its EF residual, PowerSGD's orthogonalization and rank-2
   approximation at 1e-5); (b) four gloo ranks of this script
   (``--gs-train``) on the card train BERT-base at full width and 3 of
   its 12 layers (32 x 128 a rank, SGD 0.1, 2 eager steps) under every
   compressor, the two-leg int8 + EF wire split 2 hosts x 2
   (``AUTODIST_HIER_ICI=2``) and ``AllReduce()`` with the overlap
   scheduler on and off (16 MiB buckets, deterministic algorithms), each
   held to its one-rank reference (the same wire on one rank, the whole
   batch) between the floor and the planted fault, the ranks' params
   equal, 3 launches of each flash kernel a rank and step, the wire bytes
   a rank and step per leg equal to ``hier_wire_split``'s prediction and
   the overlap on / off params bitwise equal; (c) one profiled
   ``Runner.run`` a rank: its measured exposed comms beside the cost
   model's estimate and the attribution's sources; the phase's seconds;
25. output: one ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``. No process the script starts
   outlives it: its children stay in its process group, it adopts their
   orphans, a SIGTERM takes them along, and a process still there after
   the last phase fails the run.

On four cards, ``python3 chip_smoke.py --cards 4 [--part a|b|c|d|e]`` runs
the four-card phase alone instead (it refuses to run on fewer cards): the
kernels built once; each run's one-rank reference, its floor (the
reference again) and its planted fault (twice the learning rate: a
doubled gradient) on card 0, each model's tolerances checked between
them; then ONE world of four processes, one a card, started with
torchrun's environment so that ``AutoDist`` -> ``Cluster.start`` opens
the NCCL world, runs every selected run eagerly and through
``make_callable(aot=True)`` (and ``run(unroll=4)`` for (a)'s
``AllReduce()``): (a) BERT-base MLM, 32 x 128 a card, under
``AllReduce()``, ``PS()``, ``PartitionedPS()``, ``Parallax()`` and
``PS(staleness=2)`` (held to the mean of four one-rank runs on each
replica's rows), ResNet-50 at 64 x 224^2 a card (timed only: its
batch-norm statistics are a rank's), a checkpoint saved on four cards
and restored on one and the reverse, and the 1 -> 4 card scaling of both
graph steps; (b) lm1b width on ``{seq: 4}`` (ring and Ulysses, 2 x
16384), BERT-base under ``ModelParallel(AllReduce() | PS())`` on
``{data: 2, model: 2}``, the Switch-Base-8 layer on ``{data: 2, expert:
2}`` (AllReduce: global routing; PS: per shard), lm1b uncut under
``Pipeline(4, 8)`` on ``{pipe: 4}``; (c) BERT-base under
``ModelParallel(SequenceParallel("ring", 2), 2)`` and lm1b under
``SequenceParallel("ring", 2, base=Pipeline(2, 4))``; (d) phase 17's
two runs, lm1b on ``{pipe: 2, model: 2}`` and the MoE layer on
``{expert: 2, model: 2}``; (e) BERT-base as (a) under int8 + EF,
PowerSGD (each held to the same wire on one card) and the DCN spec
(``AUTODIST_HIER_ICI=2``), ``AllReduce()`` with the overlap scheduler off
and on (16 MiB buckets; the 1 -> 4 scaling of its graph step) and
``PS()`` with ``AUTODIST_ZERO1_AG_SCOPE=use`` under ``run(unroll=4)``,
each rank's exposed comms measured from a profiled ``run(unroll=4)``.
Each run: losses
and the whole update held to its reference, the graph step to the eager
one, the ranks' losses and replicated params bitwise equal, one strategy
shipped to all, the launches a rank and step as counted from the code
(per replay under the graph); prints the step ms eager and graph, rank
0's profiled NCCL kernel ms and busy share (the pipe stage's against the
bubble 3/11), peak memory and stored bytes. Its last line is the default
run's, with the count of cards it drove.
"""
import collections
import contextlib
import copy
import functools
import glob
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Kernel vs plain version: a bf16 o at these (bf16 output rounds at 2^-8
# relative), lse at an absolute 1e-4 (both sum f32 products of the same
# inputs, in another order).
O_ATOL, O_RTOL, LSE_ATOL = 1.6e-2, 1e-2, 1e-4
# An f32 o (the training path's call) at this absolute error: bf16 inputs
# carry P into P.V as a bf16 pair (hi + residual, ~16 bits), which read
# 4.5e-6 on the card; P rounded once to bf16 reads ~1.5e-3 at the training
# shape, and the phase requires that reading above this limit.
O_F32_ATOL = 5e-5
# Served answers vs the port's forward on the request's rows alone with the
# plain attention: twelve bf16 layers, other matmul shapes (the bucket's
# padded rows) and another summation order inside attention.
SERVE_ATOL, SERVE_RTOL = 5e-2, 5e-2
# Backward kernels vs plain version, relative to the largest |gradient|.
# bf16 inputs carry ds as a bf16 pair (~2^-17) into ds.k and ds^T.q (dq,
# dk: read at most 6.6e-6 on the card; ds rounded once reads ~2e-3, which
# the phase requires above the limit) and round p once to bf16 (2^-9
# relative) before p^T.do (dv), with f32 accumulation; the plain version
# keeps everything in f32. f32 inputs differ only in summation order.
BWD_REL_DQDK_BF16, BWD_REL_DV_BF16, BWD_REL_F32 = 1e-4, 1e-2, 1e-5
# Training step 1, kernels vs the plain attention (autograd through the
# plain forward), both in the bf16-compute model: |loss difference| (the
# loss is ~10.3), the relative difference of the global grad norm, and for
# each attention q/k/v projection kernel max|grad difference| relative to
# its max |grad|. The two paths round to bf16 at different places; at this
# initialization the q/k projection gradients are ~1e-5 against ~1e-3 for
# the rest, so both bf16 paths sit a few percent (of the max) off the same
# step in an f32-compute model, which the phase prints. Hence 1e-1 for the
# two apart, and the kernel path no further from the f32 model than 1.5x
# the plain path.
TRAIN_LOSS_ATOL, TRAIN_NORM_RTOL, TRAIN_LEAF_REL = 1e-3, 5e-3, 1e-1
TRAIN_F32_RATIO = 1.5
# The H100 SXM's published peaks (NVIDIA data sheet, dense): bf16 tensor
# cores, f32 outside the tensor cores (the FMA kernels), memory.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Phase 5, step 1 of ResNet-50 (bf16 compute) against the same step of the
# model computing in f32: the loss within 1e-2 relative, and the whole
# gradient (all leaves as one vector) at cosine >= ZOO_GRAD_COS and
# |g - g_f32| / |g_f32| <= ZOO_GRAD_REL. Not leaf by leaf: through a deep
# ResNet's batch norms the bf16 gradient drifts far from the f32 one in the
# JAX package too, and the port drifts as far (the gradient-gap test in
# tests/test_torch_models.py: CIFAR ResNet-20, cosine 0.978 and relative L2
# 0.211 in the JAX package, 0.979 and 0.206 in the port). At batch 64 x
# 224^2 on an H100 80GB HBM3 (700 W) this phase read cosine 0.938 and
# relative L2 0.353, both precisions, with the median leaf 0.64 of its max
# off; the limits keep ~0.09 / ~0.15 of room.
ZOO_LOSS_RTOL, ZOO_GRAD_COS, ZOO_GRAD_REL = 1e-2, 0.85, 0.5
# cuDNN's layout-transpose kernels, as the profiler names them: one around a
# conv means its activation and kernel reached it in different formats.
TRANSPOSE_KERNELS = ("nchwToNhwc", "nhwcToNchw")
# Phase 5's profiled step by kind of kernel, first match wins (cuDNN's and
# cuBLAS's kernel names carry these; everything else is "other").
KERNEL_GROUPS = (("batch norm", ("batch_norm",)),
                 ("conv / matmul", ("conv", "xmma", "implicit_gemm", "fprop",
                                    "dgrad", "wgrad", "cudnn", "cutlass",
                                    "nvjet", "gemm", "sm90_")),
                 ("optimizer", ("multi_tensor", "foreach")),
                 ("copy / cast", ("copy", "Cat")))
# (b, h, sq, sk, d) of BERT-base's attention at the training run's batch 32
# x seq 128, and at serving's bucket 8 x seq 512.
TRAIN_SHAPE = (32, 12, 128, 128, 64)
SERVE_SHAPE = (8, 12, 512, 512, 64)
# Back-to-back calls per timing (profiler and events alike), and profiles
# taken before a call is timed with CUDA events instead; ``timed`` tallies
# its profiles, those that held no device time and its event timings.
TIMED_CALLS = 20
PROFILE_ATTEMPTS = 5
TIMINGS = {"profiles": 0, "empty": 0, "events": 0}
# PyTorch's f32 -> bf16 cast kernel, as the profiler names it.
CAST_KERNEL = "bfloat16_copy_kernel"
# Phase 6, lm1b decode: the lanes' (slots, cache_len) buckets, the traffic,
# and the requests whose teacher-forced logits are held against the port's
# full-prefix recompute (encode with the dense attention, padded to the
# lane's cache length). Both paths compute in bf16 but in other matmul
# shapes (one row per slot against the whole padded sequence), so their bf16
# roundings part by an ulp here and there through 16 layers; the tolerance is
# max |diff| relative to the largest |logit|.
DECODE_BUCKETS = ((8, 256), (32, 1024))
DECODE_REQUESTS, DECODE_CLIENTS, DECODE_CHECKED = 64, 4, 4
DECODE_LOGIT_RTOL = 5e-2
# Phase 7, the training step as CUDA graphs: each graph path's per-step
# losses against the eager path's, relative. The paths start from the same
# state, but not every gradient is bitwise between runs (the MLM gather's
# backward and the embedding lookup's scatter-add atomics), so the
# trajectories part after step 1. The unrolled path fuses this many steps
# per graph, and the busy share is read over this many unprofiled steps.
GRAPH_LOSS_RTOL = 1e-2
GRAPH_UNROLL = 4
BUSY_WINDOW = 5
# Phase 8, the strategy builders on one rank: every builder lowers to the
# replicated update there (a stale one to the local update, whose average
# over one rank is the identity), so each computes AllReduce's step. Step
# 1's loss (before any update) is bitwise AllReduce's; later ones part only
# through gradients that are not bitwise between runs (the MLM gather's and
# the embedding lookup's scatter-add atomics), which four steps of Adam
# carry into the loss far below this relative tolerance. Parallax's 20
# aot steps are held to AllReduce's aot steps (the same capturable Adam)
# at STRATEGY_GRAPH_RTOL. Each tolerance is checked to lie between two
# readings of the same run: AllReduce() again from the same init (the
# floor the atomics leave) and AllReduce() at twice the learning rate (a
# planted fault, the update doubled), which the check must see. Read on
# an H100: eager floor 1.8e-5 and 3.1e-5, fault 2.5e-2; aot floor 8.7e-4
# and 1.4e-3 (Parallax, which computes AllReduce's step on one rank, read
# up to 2.5e-3 from it), fault 5.8e-2.
STRATEGY_STEPS = 4
STRATEGY_GRAPH_STEPS = 20
STRATEGY_LOSS_RTOL = 1e-3
STRATEGY_GRAPH_RTOL = 1e-2
# Phase 9, training that survives: BERT's graph step (K = RESIL_UNROLL
# steps a CUDA graph) under CheckpointManager.run with a checkpoint every
# RESIL_INTERVAL steps and a StepGuard reading the flag every RESIL_CHECK,
# a NaN batch at step RESIL_NAN_AT (the first step of a K-block: a block's
# batch is poisoned when nan_at names its first step, as in the JAX
# package's CheckpointManager.run); then an uninterrupted run of
# RESIL_RESUME_STEPS steps over distinct batches against a resume from its
# step RESIL_RESUME_FROM in a fresh Runner. The resumed losses are held at
# RESUME_RTOL (max relative difference) and the resumed update at
# RESUME_UPDATE_RTOL (``update_error`` over the resumed steps); each must
# lie between two uninterrupted runs of the program (the floor: the
# gradients' atomics) and a planted fault (the resume with Adam's moments
# zeroed). Read on an H100 (distinct random batches: the loss moves little):
# losses floor 3.0e-5, fault 1.3e-3, resumed 1.4e-5; update floor 2.6e-2,
# fault 0.93, resumed 2.5e-3. A preempted child process gets its
# SIGTERM while it fetches batch PREEMPT_AT; the guard's cost is read over
# GUARD_COST_STEPS graph steps.
RESIL_STEPS, RESIL_RESUME_STEPS, RESIL_RESUME_FROM = 12, 16, 8
RESIL_INTERVAL, RESIL_CHECK, RESIL_NAN_AT, RESIL_UNROLL = 4, 2, 5, 2
RESUME_RTOL, RESUME_UPDATE_RTOL = 2e-4, 0.2
PREEMPT_AT = 4
GUARD_COST_STEPS = 20
# (f), the save stall: K-step graphs timed before and after a save.
SAVE_STALL_STEPS = 5

# Phase 10, sequence parallelism. (a) One process emulates a ring of
# SP_HOPS ranks over a global causal sequence at lm1b's attention width
# (b, h, s, d = SP_SHAPE, bf16): every hop's block_attn_fwd / _bwd against
# its plain version (the phase 2 tolerances: f32 o at O_F32_ATOL, lse at
# LSE_ATOL, dq / dk at BWD_REL_DQDK_BF16 and dv at BWD_REL_DV_BF16 of the
# max), then the ring's o, dq, dk and dv against one flash_attention call
# over the whole sequence, relative to each one's max |value|: both round
# to bf16 once at the end (2^-8 relative), the ring summing its hops in
# f32 in another order. SP_RING_REL must lie between the ring's reading
# and a planted fault (one hop dropped). (b) SP_WORLD gloo ranks (processes
# of this script) on the one card train lm1b's widths at SP_LAYERS layers
# and max_len SP_MAX_LEN on SP_BATCH x SP_MAX_LEN tokens, SGD SP_LR, under
# SequenceParallel("ring") and ("ulysses"), each rank its half of the
# sequence; their losses and update are held to one rank's AllReduce()
# steps over the whole sequence at SP_LOSS_RTOL / SP_UPDATE_RTOL, each
# between the floor (that run again) and a planted fault (each rank's
# attention local to its chunk: block-diagonal).
SP_SHAPE, SP_HOPS = (2, 16, 16384, 64), 4
SP_RING_REL = 1e-2
SP_WORLD, SP_LAYERS, SP_MAX_LEN, SP_BATCH = 2, 2, 4096, 2
SP_STEPS, SP_LR = 3, 0.1
SP_LOSS_RTOL, SP_UPDATE_RTOL = 2e-4, 5e-2

# Phase 11, tensor parallelism. TP_WORLD gloo ranks (processes of this
# script) on the one card train BERT-base under ModelParallel over each
# base of TP_BUILDERS on {data: 1, model: TP_WORLD}, TP_STEPS eager SGD
# steps at TP_LR, each rank its pieces of every layer; losses and the
# update are held to one rank's AllReduce() steps at TP_LOSS_RTOL /
# TP_UPDATE_RTOL, each between the floor (that run again) and the planted
# faults of TP_FAULTS (the gathered gradient undivided; the copy-to-model
# backward all-reduce dropped). The model computes in bf16: a row-parallel
# product is two bf16 partial sums added (one rank rounds the whole sum
# once), so the runs part by bf16 roundings. The flash kernels run on each
# rank's heads at TP_SHAPE (b, h, sq, sk, d).
TP_WORLD, TP_STEPS, TP_LR = 2, 4, 0.1
TP_LOSS_RTOL, TP_UPDATE_RTOL = 1e-3, 5e-2
TP_BUILDERS = (("allreduce", "AllReduce"), ("ps", "PS"))
TP_FAULTS = ("undivided", "no_allreduce")
TP_SHAPE = (32, 6, 128, 128, 64)

# Phase 12, expert parallelism: one MoE layer at Switch-Base-8's widths
# (google/switch-base-8: d_model 768, d_ff 3072, 8 experts) with
# MoEConfig's top_k 2 and capacity_factor 1.25 and bf16 compute, trained
# as the JAX package trains the layer (tests/test_moe.py:84-116,
# bench.py:562-583): moe.apply -> a linear head of EP_CLASSES classes ->
# cross-entropy + 0.01 aux, on x of (EP_BATCH, EP_SEQ, 768) (T = 4096
# tokens, capacity 1280). One rank takes EP_STEPS eager SGD steps at EP_LR,
# again (the floor), and through make_callable(aot=True); then EP_WORLD
# gloo ranks (processes of this script) on the one card train under
# ModelParallel(rules=moe.EXPERT_RULES, mesh_axis="expert") over each base
# of EP_BUILDERS on {data: 1, expert: EP_WORLD}, each rank its E/ep
# experts, and over AllReduce with each fault of EP_FAULTS (the
# copy-to-expert backward dropped, the aux loss's gradient summed over the
# expert group, the gathered gate gradient left undivided). Losses and the
# update are held to one rank's AllReduce() steps at EP_LOSS_RTOL and
# EP_UPDATE_RTOL (the largest relative L2 error of one param's update: the
# gate holds 0.02% of the parameters, so a fault in its gradient hides in
# the whole update's error), each between the floor and the faults' least reading:
# the update's over EP_FAULTS, the loss's over EP_LOSS_FAULTS. The aux
# fault moves only the gate's gradient, by 0.01 x aux's part of it, and the
# loss by as little as the EP run's own rounding does (2.3e-6 against
# 2.1e-6): it is read on the update. Read on an H100: the floor 0 (the
# one-rank step is bitwise repeatable, and its graph bitwise the eager
# step); the EP runs 2.1e-6 (loss) and 9.8e-4 (the up kernel's update;
# the expert products' gradients over 4 experts round otherwise than over
# 8); faults: copy-to-expert backward dropped 1.5e-4 / 0.50 (the gate),
# gate gradient undivided 2.2e-4 / 1.00, aux summed 2.3e-6 / 3.8e-3.
EP_D, EP_H, EP_E = 768, 3072, 8
EP_BATCH, EP_SEQ, EP_CLASSES = 32, 128, 4
EP_WORLD, EP_STEPS, EP_LR = 2, 4, 0.1
EP_LOSS_RTOL, EP_UPDATE_RTOL = 2e-5, 2e-3
EP_BUILDERS = (("allreduce", "AllReduce"), ("ps", "PS"))
EP_FAULTS = ("no_copy", "aux_summed", "undivided")
EP_LOSS_FAULTS = ("no_copy", "undivided")

# Phase 13, pipeline parallelism: lm1b at full width (vocab 32000, dim 1024,
# 16 heads of 64, PP_LAYERS of its 16 layers, bf16 compute) in the stacked
# layout
# (TransformerConfig(scan_layers=True)), PP_BATCH x PP_SEQ tokens, SGD
# PP_LR, PP_STEPS eager steps. (a) One rank: eagerly, again (the floor),
# through make_callable(aot=True) (its losses bitwise the eager ones) and
# with the same weights unstacked (losses within PP_UNSTACKED_RTOL). (b)
# PP_WORLD gloo ranks (processes of this script) on the one card under
# Pipeline(num_stages=PP_WORLD, num_microbatches=PP_MICRO) on {data: 1,
# pipe: PP_WORLD}, each rank storing and running L / PP_WORLD layers, under
# each schedule of PP_SCHEDULES, shift again (the pipelined floor), and
# shift with each fault of PP_FAULTS (the whole parameters' gradients not
# summed over the pipe group; every rank's backward seeded 1, not 1 / S:
# the head counted on every rank). Losses and the update are held to one
# rank's AllReduce() steps at PP_LOSS_RTOL / PP_UPDATE_RTOL, each between
# the one-rank floor and the faults' least reading; sequential and 1f1b
# to shift within the pipelined floor (bitwise where it reads 0).
PP_WORLD, PP_MICRO, PP_STEPS, PP_LR = 2, 4, 3, 0.1
PP_BATCH, PP_SEQ = 8, 1024
# lm1b's depth in phases 13, 15, 17 and 19, cut from 16 to 4 layers to keep
# the full run well inside its 1200 s limit (the gloo phases run up to a
# third slower on some hosts); Pipeline() still resolves (4, 8) for it on
# four ranks, as phase 19 (c) checks.
PP_LAYERS = 4
PP_SCHEDULES = ("shift", "sequential", "1f1b")
PP_FAULTS = ("data_only", "head")
PP_LOSS_RTOL, PP_UPDATE_RTOL = 1e-4, 5e-2
PP_UNSTACKED_RTOL = 1e-5

# Phase 14, BERT's MLM loss under a seq axis: BERT-base at full width and
# depth, the MLM batch CP_BATCH x CP_SEQ with CP_MASKED masked positions,
# SGD CP_LR, CP_STEPS eager steps. One rank's AllReduce() steps and the
# same again (the floor); then gloo ranks (processes of this script) on
# the one card: (a) SequenceParallel("ring") on {data: 1, seq: 2}, (b)
# ModelParallel(SequenceParallel(ring | ulysses, 2), 2) on {data: 1, seq:
# 2, model: 2} (6 heads and a 64-row chunk a rank). Losses and the whole
# update are held to one rank's at CP_LOSS_RTOL / CP_UPDATE_RTOL, each
# between the floor and the planted faults' least reading: every rank's
# attention local to its chunk (block-diagonal; (a) and (b)), the gathered
# embedding gradient left undivided by the model size ((b)).
CP_BATCH, CP_SEQ, CP_MASKED, CP_STEPS, CP_LR = 32, 128, 20, 3, 0.1
CP_LOSS_RTOL, CP_UPDATE_RTOL = 1e-3, 5e-2
CP_SP_FAULTS = ("local",)
CP_TP_FAULTS = ("local", "undivided")
# Phase 15, pipeline x sequence parallelism: phase 13's LM (lm1b at
# PP_LAYERS, stacked) and batch, under SequenceParallel("ring", 2,
# base=Pipeline(2, PP_MICRO)) on {data: 1, pipe: 2, seq: 2}, four gloo
# ranks, each storing and running PP_LAYERS / 2 layers on its 512-row chunk, under shift and 1f1b; held to
# phase 13's one-rank steps at PPSP_LOSS_RTOL / PPSP_UPDATE_RTOL, each
# between the one-rank floor and the planted fault (the pipe hop sent to
# the next stage's rank of the other chunk); 1f1b bitwise shift.
PPSP_SCHEDULES = ("shift", "1f1b")
PPSP_FAULTS = ("crossed",)
PPSP_LOSS_RTOL, PPSP_UPDATE_RTOL = 1e-4, 5e-2
# The hop shapes of the two phases' rings (b, h, s_chunk, d) and Ulysses'
# attention under TP (b, h, sq, sk, d), held against the plain versions:
# BERT-base's 12 heads on {seq: 2} and a TP rank's 6 on {seq: 2, model: 2}
# over a 64-row chunk, lm1b's 16 heads over a 512-row chunk.
SP_HOP_SHAPE = (32, 12, 64, 64)
CP_HOP_SHAPE = (32, 6, 64, 64)
PPSP_HOP_SHAPE = (2, 16, 512, 64)
CP_ULYSSES_SHAPE = (32, 3, 128, 128, 64)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def adopt_orphans():
    """Make this process the reaper of its descendants (Linux
    ``PR_SET_CHILD_SUBREAPER``, on this process only): a process whose
    parent dies first (phase 23's worker, if its chief goes) becomes this
    process's child, where :func:`stop_descendants` finds it."""
    import ctypes
    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)


# What a rank or a phase-23 job imports before its first step.
CHILD_IMPORTS = ("torch._dynamo", "torch.distributed", "autodist_tpu_torch",
                 "autodist_tpu_torch.autodist",
                 "autodist_tpu_torch.checkpoint",
                 "autodist_tpu_torch.coordinator",
                 "autodist_tpu_torch.models.bert",
                 "autodist_tpu_torch.models.lm",
                 "autodist_tpu_torch.parallel.moe",
                 "autodist_tpu_torch.strategy", "chip_smoke")


def child_bytecode_cache(build_dir):
    """Let every process this script starts keep the bytecode it compiles
    under ``build_dir/pycache`` (``PYTHONPYCACHEPREFIX``), also where the
    environment forbids writing it beside the sources
    (``PYTHONDONTWRITEBYTECODE``): there each child would compile torch's
    Python sources anew, ~20 s a process on a slow host. Starts, and
    returns, one child that fills the cache with ``CHILD_IMPORTS`` while
    phase 1 builds the kernels."""
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(build_dir, "pycache")
    return subprocess.Popen(
        [sys.executable, "-c", "import " + ", ".join(CHILD_IMPORTS)],
        cwd=ROOT)


def _children():
    """{parent pid: [child pids]} of every process /proc lists now."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        out.setdefault(ppid, []).append(int(name))
    return out


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return "?"


def stop_descendants(root=None, spare=()):
    """SIGKILL every process below ``root`` (default: this process) but
    those in ``spare`` and below them, and reap those that are this
    process's children; returns a line for each process that was found."""
    me = os.getpid()
    root = root or me
    found = []
    for _ in range(10):  # a process may fork while its parent dies
        tree, todo, pids = _children(), [root], []
        while todo:
            for child in tree.get(todo.pop(), []):
                if child not in spare:
                    pids.append(child)
                    todo.append(child)
        if not pids:
            break
        for pid in pids:
            found.append(f"pid {pid}: {_cmdline(pid)[:200]}")
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for pid in tree.get(me, []):
            if pid in pids:
                try:
                    os.waitpid(pid, 0)
                except ChildProcessError:
                    pass
        time.sleep(0.1)
    return found


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    check(lines, "nvidia-smi reported no card")
    return lines[0]


def _device_us(event):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _device_events(prof):
    """The profile's device activity by name: kernels, copies and memsets.
    A ``record_function`` range mirrored on the device timeline (the
    optimizer's ``Optimizer.step#...``) spans kernels already counted, so
    it is left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0 and
            not getattr(e, "is_user_annotation", False)]


def timed(torch, fn, n=TIMED_CALLS, warmup=3):
    """Times one call of ``fn`` on the card, after ``warmup`` calls.

    ``ms``: device time, from ``torch.profiler`` over ``n`` back-to-back
    calls: for every kernel the calls launched, its mean device time per
    launch times its launches per call, summed (``kernels``: {kernel name:
    launches recorded per call}; a profile can drop events, which shows as
    a fraction there and leaves the per-launch mean intact). The profile
    traces ``n`` calls as its warm-up step and keeps the next ``n``: a
    window traced from the instant tracing starts can come back without
    device activity. A profile that still holds no device time is taken
    again, up to ``PROFILE_ATTEMPTS`` times; after that, ``ms`` comes from
    CUDA events around ``n`` calls queued behind a sleep kernel, so that
    the events time the card's work and not the host's launches
    (``timer``: "profiler" or "events"; ``kernels`` is then empty).
    ``host_ms``: CUDA events around another ``n`` back-to-back calls, over
    ``n``; it includes what the call does on the host before its kernels
    reach the stream, and is the call's cost where the host cannot run
    ahead of the card.
    """
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(warmup):
        fn()
    total, events = 0.0, []
    for attempt in range(PROFILE_ATTEMPTS):
        TIMINGS["profiles"] += 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = _device_events(prof)
        total = sum(_device_us(e) / e.count * max(1, round(e.count / n))
                    for e in events)
        if total > 0:
            break
        TIMINGS["empty"] += 1
        print(f"  (profile {attempt + 1} of {PROFILE_ATTEMPTS} held no device "
              f"time)", flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    host_ms = start.elapsed_time(end) / n
    if total > 0:
        return {"ms": total / 1e3, "host_ms": host_ms, "timer": "profiler",
                "kernels": {e.key: e.count / n for e in events}}
    ms = queued_ms(torch, fn, n, host_ms)
    TIMINGS["events"] += 1
    print(f"  (timed with CUDA events instead: {ms:.4f} device ms per call "
          f"over {n} calls queued behind a sleep kernel; host-inclusive "
          f"{host_ms:.4f})", flush=True)
    return {"ms": ms, "host_ms": host_ms, "timer": "events", "kernels": {}}


def sleep_cycles_per_ms(torch):
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card (measured
    once)."""
    if "sleep_cycles_per_ms" not in TIMINGS:
        cycles = 10 ** 7
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)  # the first call loads the kernel
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        TIMINGS["sleep_cycles_per_ms"] = cycles / start.elapsed_time(end)
    return TIMINGS["sleep_cycles_per_ms"]


def queued_ms(torch, fn, n, host_ms):
    """Device ms per call of ``fn``: CUDA events around ``n`` calls that
    the host queues while a sleep kernel holds the stream for twice the
    time it took them to launch, plus 5 ms; the events then open on a
    full queue and time the card's work alone (the queue drains back to
    back). A call that waits on the card inside ``fn`` empties the queue,
    and its time is then host-inclusive, as ``host_ms`` is."""
    hold = 2 * n * host_ms + 5.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(hold * sleep_cycles_per_ms(torch)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def kernel_names(t):
    if not t["kernels"]:
        return "no kernel the profiler named (timed with CUDA events)"
    return ", ".join(f"{name[:70]} x{count:g}"
                     for name, count in t["kernels"].items())


def attention_work(q, k, v, *outs):
    """(operations, bytes) of one non-causal call: 4 flops per (q, k) pair
    and head-dim element; each input read once, each output (o, lse and
    any second o) written once."""
    b, h, sq, d = q.shape
    flops = 4.0 * b * h * sq * k.shape[2] * d
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, *outs))
    return flops, nbytes


def fwd_p_rounded_once(torch, q, k, v):
    """The plain forward (f32 o) with P rounded once to bf16 before P.V:
    what a kernel without P's residual term would give."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * q.shape[-1] ** -0.5
    p =torch.exp(s - s.amax(-1, keepdim=True))
    return torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                        v.float()) / p.sum(-1, keepdim=True)


def bwd_ds_rounded_once(torch, q, k, v, do, lse, delta):
    """The plain (dq, dk) with ds rounded once to bf16 before ds.k and
    ds^T.q: what the kernels without ds's residual term would give."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (torch.exp(s - lse) * (dp - delta) * scale).bfloat16().float()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float()),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.float()))


def kernel_phase(torch, fa):
    """Phase 2: flash_fwd vs flash_fwd_reference on the card, then its
    times beside the plain version's, SDPA's and the bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, h, sq, sk, d, dtype):
        return [torch.randn((b, h, s, d), generator=gen, device=dev,
                            dtype=dtype) for s in (sq, sk, sk)]

    errs = {"o": 0.0, "lse": 0.0}

    def compare(name, q, k, v, causal=False, q_offset=0, k_offset=0,
                out_dtype=None, all_empty=False, with_lowp=False):
        got = fa.flash_fwd(q, k, v, causal, q_offset, k_offset, out_dtype,
                           with_lowp)
        again = fa.flash_fwd(q, k, v, causal, q_offset, k_offset, out_dtype,
                             with_lowp)
        torch.cuda.synchronize()
        o, lse = got[:2]
        ro, rl = fa.flash_fwd_reference(q, k, v, causal, q_offset, k_offset,
                                        out_dtype)
        check(o.dtype == ro.dtype and o.shape == ro.shape and
              lse.shape == rl.shape, f"{name}: output dtype/shape differ")
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"{name}: non-finite output")
        err_o = (o.float() - ro.float()).abs().max().item()
        err_l = (lse - rl).abs().max().item()
        line = (f"  {name}: max|o-o_plain| {err_o:.3e}  max|lse-lse_plain| "
                f"{err_l:.3e}, repeat bitwise")
        atol, rtol = ((O_F32_ATOL, 0.0) if o.dtype == torch.float32
                      else (O_ATOL, O_RTOL))
        check(torch.allclose(o.float(), ro.float(), atol=atol, rtol=rtol),
              f"{name}: o differs from the plain version by {err_o} "
              f"(atol {atol}, rtol {rtol})")
        check(torch.allclose(lse, rl, atol=LSE_ATOL, rtol=0),
              f"{name}: lse differs from the plain version by {err_l}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: a repeated call is not bitwise identical")
        if with_lowp:
            check(got[2].dtype == q.dtype and
                  torch.equal(got[2], o.to(q.dtype)),
                  f"{name}: the kernel's {q.dtype} o is not its f32 o cast")
            line += f"; its {str(q.dtype)[6:]} o == its f32 o cast, bitwise"
        if all_empty:
            check(bool((o == 0).all()) and bool((lse == -1e30).all()),
                  f"{name}: rows with no visible key must give o == 0 and "
                  f"lse == -1e30")
        print(line, flush=True)
        errs["o"] = max(errs["o"], err_o)
        errs["lse"] = max(errs["lse"], err_l)
        return o, lse

    bf16, f32 = torch.bfloat16, torch.float32
    print(f"phase 2: flash_fwd kernel vs its plain version (bf16 o: atol "
          f"{O_ATOL}, rtol {O_RTOL}; f32 o: atol {O_F32_ATOL}; every call "
          f"repeated)", flush=True)
    qa, ka, va = qkv(*SERVE_SHAPE, bf16)
    compare("(a) bert-base b8 h12 s512 d64 bf16", qa, ka, va)
    q, k, v = qkv(4, 16, 1024, 1024, 64, bf16)
    compare("(b) lm1b b4 h16 s1024 d64 bf16 causal", q, k, v, causal=True)
    q, k, v = qkv(2, 12, 512, 512, 64, bf16)
    compare("(c) offsets (512, 1024) causal: every row empty", q, k, v,
            causal=True, q_offset=512, k_offset=1024, all_empty=True)
    compare("(c) offsets (1024, 512) causal: every key visible", q, k, v,
            causal=True, q_offset=1024, k_offset=512)
    compare("(c) bf16 in, f32 out, causal", q, k, v, causal=True,
            out_dtype=f32)
    qt, kt, vt = qkv(*TRAIN_SHAPE, bf16)
    o_t, _ = compare("(t) training b32 h12 s128 d64 bf16 in, f32 + bf16 "
                     "out", qt, kt, vt, out_dtype=f32, with_lowp=True)
    ro_t = fa.flash_fwd_reference(qt, kt, vt, out_dtype=f32)[0]
    once = (fwd_p_rounded_once(torch, qt, kt, vt) - ro_t).abs().max().item()
    print(f"  (t) with P rounded once to bf16 the plain version reads "
          f"{once:.3e} (the kernel {(o_t - ro_t).abs().max().item():.3e}, "
          f"atol {O_F32_ATOL})", flush=True)
    check(once > O_F32_ATOL, f"the f32-output tolerance {O_F32_ATOL} would "
          f"pass a kernel rounding P once ({once})")
    del ro_t
    for d in (16, 32, 128):
        q, k, v = qkv(2, 3, 200, 200, d, f32)
        compare(f"(d) f32 s200 d{d}", q, k, v)
        compare(f"(d) f32 s200 d{d} causal", q, k, v, causal=True)
    q, k, v = qkv(2, 3, 200, 200, 128, bf16)
    compare("(e) bf16 d128 s200 causal (ragged)", q, k, v, causal=True)
    q, k, v = qkv(2, 3, 200, 333, 128, bf16)
    compare("(e) bf16 d128 sq200 sk333 causal q_offset 100", q, k, v,
            causal=True, q_offset=100)
    q, k, v = qkv(2, 4, 300, 300, 128, bf16)
    compare("(e) bf16 d128 s300 f32 + bf16 out", q, k, v, out_dtype=f32,
            with_lowp=True)
    for d in (16, 32):
        q, k, v = qkv(2, 3, 200, 200, d, bf16)
        compare(f"(e) bf16 d{d} s200 causal f32 + bf16 out (mma.sync)", q, k,
                v, causal=True, out_dtype=f32, with_lowp=True)
    x = torch.randn((4, 256, 3 * 768), generator=gen, device=dev, dtype=bf16)
    q, k, v = [t.reshape(4, 256, 12, 64).transpose(1, 2)
               for t in x.split(768, -1)]
    compare("(f) the model's layout: (b, h, s, d) views of (b, s, h, d) "
            "memory, causal", q, k, v, causal=True)
    buf = torch.randn((2, 3, 100, 65), generator=gen, device=dev, dtype=bf16)
    compare("(f) rows 65 elements apart (copied for TMA)", buf[..., 1:],
            buf[..., 1:], buf[..., 1:])
    # batch x heads past grid.y's 65535 on every route (BERT-base serving
    # at a bucket over 5461 rows): the persistent TMA / wgmma kernel, and the
    # tiled mma.sync and FMA kernels on their 1-D grid.
    for (b, h, s, d), dtype in (((5462, 12, 128, 64), bf16),
                                ((5462, 12, 64, 32), bf16),
                                ((5462, 12, 32, 16), f32)):
        q, k, v = qkv(b, h, s, s, d, dtype)
        compare(f"(g) b{b} h{h} (b*h {b * h}) s{s} d{d} {str(dtype)[6:]} "
                f"causal", q, k, v, causal=True)
        del q, k, v

    def timings(q, k, v, label, **kw):
        out = fa.flash_fwd(q, k, v, **kw)
        flops, nbytes = attention_work(q, k, v, *out)
        bound_ms, bound_by = bound(flops, nbytes)
        kern = timed(torch, lambda: fa.flash_fwd(q, k, v, **kw))
        plain = timed(torch, lambda: fa.flash_fwd_reference(q, k, v, **kw))
        lib = timed(torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(q, k, v))
        lib2 = timed(torch, lambda: torch.nn.functional
                     .scaled_dot_product_attention(q, k, v))
        check(all("flash_fwd" in name for name in kern["kernels"]),
              f"flash_fwd at {label} launched {kernel_names(kern)}")
        kinds = " + ".join(str(t.dtype)[6:] for t in (out[0], *out[2:]))
        print(f"  timing at {label} ({kinds} o), device ms per call (profiler, {TIMED_CALLS} calls) / host-"
              f"inclusive ms per call (events around {TIMED_CALLS} calls): "
              f"kernel {kern['ms']:.4f} / {kern['host_ms']:.4f}, plain "
              f"{plain['ms']:.4f} / {plain['host_ms']:.4f}, SDPA "
              f"{lib['ms']:.4f} / {lib['host_ms']:.4f} (again: "
              f"{lib2['ms']:.4f} / {lib2['host_ms']:.4f}); bound "
              f"{bound_ms:.4f} ({bound_by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB); kernel / SDPA device "
              f"{kern['ms'] / lib['ms']:.2f}x, bound / kernel "
              f"{bound_ms / kern['ms']:.3f}", flush=True)
        print(f"    launches recorded per call: {kernel_names(kern)}; SDPA's: "
              f"{kernel_names(lib)}", flush=True)
        return {"ms": kern["ms"], "host_ms": kern["host_ms"],
                "plain_ms": plain["ms"], "plain_host_ms": plain["host_ms"],
                "library_ms": lib["ms"], "library_host_ms": lib["host_ms"],
                "library_ms_again": lib2["ms"],
                "library_kernels": list(lib["kernels"]),
                "bound_ms": bound_ms, "bound_by": bound_by}, out

    at_a, _ = timings(qa, ka, va, "(a)")
    # Training's call: f32 o (saved for the backward) and the model's bf16 o
    # from one launch. The cast it replaced is timed once for the record.
    at_t, out_t = timings(qt, kt, vt, "the training shape (t)",
                          out_dtype=f32, with_lowp=True)
    cast = timed(torch, lambda: out_t[0].to(bf16))
    print(f"  a separate cast of the f32 o at (t) to bf16 (no longer run): "
          f"device {cast['ms']:.4f} ms, host-inclusive {cast['host_ms']:.4f}"
          f" ms; {kernel_names(cast)}", flush=True)
    record = {"name": "flash_fwd", "route": "cuda",
              "source": "autodist_tpu_torch/csrc/flash_fwd.cu",
              "replaces": "autodist_tpu/ops/flash_attention.py:101",
              "tpu_kernel": "_fwd_kernel",
              "design": "bf16 d64/128: persistent, TMA producer warp + two "
                        "wgmma consumer warpgroups, 2-stage K/V ring",
              "shape": list(SERVE_SHAPE[:3]) + [SERVE_SHAPE[4]],
              "max_abs_err": errs["o"], "max_err_o": errs["o"],
              "max_err_lse": errs["lse"],
              "timing": f"ms: device time per call (torch.profiler, "
                        f"{TIMED_CALLS} back-to-back calls after 3 warm-ups)"
                        f"; host_ms: CUDA events around {TIMED_CALLS} "
                        f"calls, over {TIMED_CALLS}",
              "train_shape": list(TRAIN_SHAPE[:3]) + [TRAIN_SHAPE[4]],
              "train_outputs": "float32 o + bfloat16 o",
              "train_cast_ms": cast["ms"]}
    record.update(at_a)
    record.update({"train_" + key: val for key, val in at_t.items()})
    return record


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the operations at ``peak`` (the bf16 tensor-core peak unless given) vs
    the bytes at the memory rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def backward_phase(torch, fa):
    """Phase 2, backward: flash_bwd_dq / flash_bwd_dkv vs
    flash_bwd_reference on the card, with f32 and q-dtype outputs; returns
    their two records."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {"dq": 0.0, "dkv": 0.0}

    def inputs(b, h, sq, sk, d, dtype, causal=False, q_offset=0,
               k_offset=0):
        q, k, v = [torch.randn((b, h, s, d), generator=gen, device=dev,
                               dtype=dtype) for s in (sq, sk, sk)]
        do = torch.randn((b, h, sq, d), generator=gen, device=dev,
                         dtype=dtype)
        o, lse = fa.flash_fwd(q, k, v, causal, q_offset, k_offset)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        return q, k, v, do, lse, delta

    def grads(args, extra, out_dtype):
        return (fa.flash_bwd_dq(*args, *extra, out_dtype=out_dtype),
                *fa.flash_bwd_dkv(*args, *extra, out_dtype=out_dtype))

    def compare(name, shape, dtype, causal=False, q_offset=0, k_offset=0,
                all_empty=False):
        args = inputs(*shape, dtype, causal, q_offset, k_offset)
        extra = (causal, q_offset, k_offset)
        got, again = grads(args, extra, f32), grads(args, extra, f32)
        low, low_again = grads(args, extra, dtype), grads(args, extra, dtype)
        torch.cuda.synchronize()
        ref = fa.flash_bwd_reference(*args, *extra)
        line = []
        for label, g, want in zip(("dq", "dk", "dv"), got, ref):
            tol = (BWD_REL_F32 if dtype == f32 else BWD_REL_DV_BF16
                   if label == "dv" else BWD_REL_DQDK_BF16)
            check(g.dtype == torch.float32 and g.shape == want.shape,
                  f"{name}: {label} dtype/shape differ")
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite "
                  f"{label}")
            err = (g - want).abs().max().item()
            scale = want.abs().max().item()
            line.append(f"{label} {err:.3e} (max {scale:.3e})")
            check(err <= tol * scale, f"{name}: {label} differs from the "
                  f"plain version by {err} (> {tol} x {scale})")
            key = "dq" if label == "dq" else "dkv"
            errs[key] = max(errs[key], err)
        check(all(torch.equal(a, b) for a, b in zip(got, again)) and
              all(torch.equal(a, b) for a, b in zip(low, low_again)),
              f"{name}: a repeated backward is not bitwise identical")
        check(all(lo.dtype == dtype and torch.equal(lo, g.to(dtype))
                  for lo, g in zip(low, got)),
              f"{name}: the {dtype} gradients are not the f32 ones cast")
        line.append(f"{str(dtype)[6:]} outputs == f32 outputs cast, bitwise")
        if all_empty:
            check(all(bool((g == 0).all()) for g in (*got, *low)),
                  f"{name}: rows with no visible key must give exactly 0")
            line.append("all exactly 0")
        print(f"  {name}: max|kernel-plain| " + ", ".join(line), flush=True)
        return args

    print("phase 2: flash_bwd_dq / flash_bwd_dkv kernels vs their plain "
          f"version (relative to max |grad|: bf16 dq, dk {BWD_REL_DQDK_BF16},"
          f" dv {BWD_REL_DV_BF16}; f32 {BWD_REL_F32}; every case also with "
          f"outputs in q's dtype, which must be the f32 outputs cast; "
          f"repeats bitwise)", flush=True)
    a = compare("(a) bert-base b8 h12 s512 d64 bf16", SERVE_SHAPE, bf16)
    t = compare("(t) training b32 h12 s128 d64 bf16", TRAIN_SHAPE, bf16)
    ref_t = fa.flash_bwd_reference(*t)
    once = [((a - r).abs().max() / r.abs().max()).item()
            for a, r in zip(bwd_ds_rounded_once(torch, *t), ref_t)]
    print(f"  (t) with ds rounded once to bf16 the plain version reads dq "
          f"{once[0]:.3e}, dk {once[1]:.3e} of the max (limit "
          f"{BWD_REL_DQDK_BF16})", flush=True)
    check(min(once) > BWD_REL_DQDK_BF16, f"the dq/dk tolerance "
          f"{BWD_REL_DQDK_BF16} would pass kernels rounding ds once ({once})")
    del ref_t
    compare("(b) lm1b b4 h16 s1024 d64 bf16 causal", (4, 16, 1024, 1024, 64),
            bf16, causal=True)
    compare("(c) offsets (512, 1024) causal: every row empty",
            (2, 12, 512, 512, 64), bf16, True, 512, 1024, all_empty=True)
    compare("(c) offsets (1024, 512) causal: every key visible",
            (2, 12, 512, 512, 64), bf16, True, 1024, 512)
    compare("(c) offsets (0, 200) causal f32: every row empty",
            (1, 2, 100, 70, 32), f32, True, 0, 200, all_empty=True)
    compare("(c) sq 200 sk 333 causal q_offset 150, ragged, d64 bf16",
            (2, 3, 200, 333, 64), bf16, True, 150, 0)
    for d in (16, 32, 128):
        compare(f"(d) f32 s200 d{d}", (2, 3, 200, 200, d), f32)
        compare(f"(d) f32 s200 d{d} causal", (2, 3, 200, 200, d), f32,
                causal=True)
        compare(f"(d) bf16 s200 d{d} causal", (2, 3, 200, 200, d), bf16,
                causal=True)
    compare("(d) bf16 sq333 sk200 d128 (dq on the TMA route, ragged)",
            (2, 3, 333, 200, 128), bf16)
    for shape, dtype in (((5462, 12, 64, 64, 64), bf16),
                         ((5462, 12, 64, 64, 32), bf16),
                         ((5462, 12, 32, 32, 16), f32)):
        compare(f"(g) b*h {shape[0] * shape[1]} s{shape[2]} d{shape[4]} "
                f"{str(dtype)[6:]} causal (past grid.y's 65535)", shape,
                dtype, causal=True)

    def timings(args, label):
        q, k, v, do, lse, delta = args
        b, h, sq, d = q.shape
        pairs = float(b * h * sq * k.shape[2] * d)
        ins = sum(x.numel() * x.element_size()
                  for x in (q, k, v, do, lse, delta))
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        lib, lib2 = [timed(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True)) for _ in range(2)]
        rows = {}
        for dtype in (f32, q.dtype):
            size = torch.tensor([], dtype=dtype).element_size()
            dq = timed(torch, lambda: fa.flash_bwd_dq(*args, out_dtype=dtype))
            dkv = timed(torch, lambda: fa.flash_bwd_dkv(*args,
                                                        out_dtype=dtype))
            plain = timed(torch, lambda: [g.to(dtype) for g in
                                          fa.flash_bwd_reference(*args)])
            check(all("flash_bwd_dq_wgmma" in n for n in dq["kernels"]) and
                  all("flash_bwd_dkv_wgmma" in n for n in dkv["kernels"]),
                  f"the backward kernels at {label} launched "
                  f"{kernel_names(dq)}; {kernel_names(dkv)}")
            dq_bound = bound(6 * pairs, ins + q.numel() * size)
            dkv_bound = bound(8 * pairs, ins + 2 * k.numel() * size)
            kind = str(dtype)[6:]
            print(f"  timing at {label}, {kind} outputs, device ms per call "
                  f"(profiler, {TIMED_CALLS} calls) / host-inclusive ms per "
                  f"call (events around {TIMED_CALLS} calls): dq kernel "
                  f"{dq['ms']:.4f} / {dq['host_ms']:.4f} (bound "
                  f"{dq_bound[0]:.4f}, {dq_bound[1]}; bound / kernel "
                  f"{dq_bound[0] / dq['ms']:.3f}), dkv kernel "
                  f"{dkv['ms']:.4f} / {dkv['host_ms']:.4f} (bound "
                  f"{dkv_bound[0]:.4f}, {dkv_bound[1]}; bound / kernel "
                  f"{dkv_bound[0] / dkv['ms']:.3f}), plain backward "
                  f"{plain['ms']:.4f} / {plain['host_ms']:.4f}, SDPA "
                  f"backward (dq, dk, dv together, bf16) {lib['ms']:.4f} / "
                  f"{lib['host_ms']:.4f} (again: {lib2['ms']:.4f} / "
                  f"{lib2['host_ms']:.4f}); the pair / SDPA backward device "
                  f"{(dq['ms'] + dkv['ms']) / lib['ms']:.2f}x", flush=True)
            print(f"    launches recorded per call: {kernel_names(dq)}; "
                  f"{kernel_names(dkv)}", flush=True)
            rows[kind] = [
                {"ms": r["ms"], "host_ms": r["host_ms"],
                 "plain_ms": plain["ms"], "plain_host_ms": plain["host_ms"],
                 "library_ms": lib["ms"], "library_host_ms": lib["host_ms"],
                 "library_ms_again": lib2["ms"],
                 "bound_ms": bnd[0], "bound_by": bnd[1]}
                for r, bnd in ((dq, dq_bound), (dkv, dkv_bound))]
        print(f"    SDPA backward's launches: {kernel_names(lib)}",
              flush=True)
        for row in rows.values():
            for r in row:
                r["library_kernels"] = list(lib["kernels"])
        return rows

    at_a = timings(a, "(a)")
    at_t = timings(t, "the training shape (t)")
    records = []
    designs = (
        "bf16 d64/128: persistent, TMA producer warp, 2-stage K/V ring; "
        "items of 128 q rows, 2 wgmma consumer warpgroups x 64 rows: SS "
        "wgmma S and dP, RS wgmma dS.K (hi + lo); f32 or bf16 dq",
        "bf16 d64: persistent, items of 128 keys; TMA producer warp (K/V "
        "double-buffered, Q/dO 2-stage ring, lse/delta by cp.async); 2 "
        "wgmma consumer warpgroups x 64 keys: SS wgmma S^T and dP^T, RS "
        "wgmma P^T.dO and dS^T.Q (hi + lo); f32 or bf16 dk/dv")
    for i, (name, tpu, line) in enumerate((
            ("flash_bwd_dq", "_bwd_dq_kernel", 219),
            ("flash_bwd_dkv", "_bwd_dkv_kernel", 258))):
        key = "dq" if i == 0 else "dkv"
        record = {
            "name": name, "route": "cuda",
            "source": "autodist_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"autodist_tpu/ops/flash_attention.py:{line}",
            "tpu_kernel": tpu, "design": designs[i],
            "shape": list(TRAIN_SHAPE[:3]) + [TRAIN_SHAPE[4]],
            "outputs": "bfloat16 (the training path's); f32_out_* fields: "
                       "float32 outputs",
            "max_abs_err": errs[key],
            "library_covers": "dq, dk and dv together"}
        record.update(at_t["bfloat16"][i])
        record.update({"f32_out_" + k: v
                       for k, v in at_t["float32"][i].items()})
        record.update({"shape_a_" + k: v
                       for k, v in at_a["bfloat16"][i].items()})
        record.update({"shape_a_f32_out_" + k: v
                       for k, v in at_a["float32"][i].items()})
        records.append(record)
    return records


def route_phase(torch, fa):
    """Phase 2, the routes off the main path: each timed at one shape like
    the main routes (device and host-inclusive ms, plain version, SDPA, the
    bound at the peak of the inputs' type). Their results were held to the
    plain version above (cases (d), (e)). Returns {wrapper name: [rows]}."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}

    def inputs(shape, dtype):
        q, k, v, do = [torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype) for _ in range(4)]
        o, lse = fa.flash_fwd(q, k, v)
        return q, k, v, do, lse, (do.float() * o.float()).sum(-1,
                                                             keepdim=True)

    def row(kernel, label, t, plain, lib, bnd):
        check(t["kernels"] and all(kernel in n for n in t["kernels"]),
              f"{kernel} at {label} launched {kernel_names(t)}")
        print(f"  route {kernel} at {label}: device ms per call {t['ms']:.4f}"
              f" / host-inclusive {t['host_ms']:.4f}, plain {plain['ms']:.4f}"
              f", SDPA {lib['ms']:.4f}; bound {bnd[0]:.4f} ({bnd[1]}); "
              f"bound / kernel {bnd[0] / t['ms']:.3f}", flush=True)
        return {"kernel": kernel, "shape": label, "ms": t["ms"],
                "host_ms": t["host_ms"], "plain_ms": plain["ms"],
                "library_ms": lib["ms"], "bound_ms": bnd[0],
                "bound_by": bnd[1]}

    print("phase 2: the routes off the main path, timed (b8 h12 s512)",
          flush=True)
    for dtype, d, kernel in ((bf16, 32, "flash_fwd_mma_kernel"),
                             (f32, 64, "flash_fwd_simt_kernel")):
        q, k, v = inputs((8, 12, 512, d), dtype)[:3]
        label = f"b8 h12 s512 d{d} {str(dtype)[6:]}"
        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS
        bnd = bound(*attention_work(q, k, v, *fa.flash_fwd(q, k, v)), peak)
        rows["flash_fwd"].append(row(
            kernel, label, timed(torch, lambda: fa.flash_fwd(q, k, v)),
            timed(torch, lambda: fa.flash_fwd_reference(q, k, v)),
            timed(torch, lambda: sdpa(q, k, v)), bnd))
    for dtype, d, kernels in (
            (bf16, 32, ("flash_bwd_dq_mma_kernel",
                        "flash_bwd_dkv_mma_kernel")),
            (bf16, 128, ("flash_bwd_dq_wgmma_kernel",
                         "flash_bwd_dkv_mma_kernel")),
            (f32, 64, ("flash_bwd_dq_simt_kernel",
                       "flash_bwd_dkv_simt_kernel"))):
        args = inputs((8, 12, 512, d), dtype)
        q, k = args[:2]
        label = f"b8 h12 s512 d{d} {str(dtype)[6:]}, {str(dtype)[6:]} out"
        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS
        pairs = float(8 * 12 * 512 * 512 * d)
        ins = sum(x.numel() * x.element_size() for x in args)
        size = q.element_size()
        leaves = [x.detach().clone().requires_grad_() for x in args[:3]]
        out = sdpa(*leaves)
        lib = timed(torch, lambda: torch.autograd.grad(
            out, leaves, args[3], retain_graph=True))
        plain = timed(torch, lambda: [g.to(dtype) for g in
                                      fa.flash_bwd_reference(*args)])
        rows["flash_bwd_dq"].append(row(
            kernels[0], label, timed(torch, lambda: fa.flash_bwd_dq(
                *args, out_dtype=dtype)), plain, lib,
            bound(6 * pairs, ins + q.numel() * size, peak)))
        rows["flash_bwd_dkv"].append(row(
            kernels[1], label, timed(torch, lambda: fa.flash_bwd_dkv(
                *args, out_dtype=dtype)), plain, lib,
            bound(8 * pairs, ins + 2 * k.numel() * size, peak)))
    return rows


def bucket_graphs(engine, replica=0):
    """{bucket: its CUDA graph} of one serving replica."""
    rep = engine.replicas[replica]
    return {b: rep.compile_bucket(b, engine.item.batch_struct)
            for b in rep.buckets_compiled}


def profile_dispatches(torch, srv, batch, n=6):
    """Where a dispatch's time goes: ``n`` sequential full-bucket requests
    under ``torch.profiler``; device time by kernel and the device's busy
    share of the wall time (kernels summed; the copy stream overlaps)."""
    from torch.profiler import ProfilerActivity, profile
    srv.infer(batch, timeout=300)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            srv.infer(batch, timeout=300)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_events(prof)
    total = sum(_device_us(e) for e in events)
    if not total:
        print("  profile: no device time in the trace (not measured)",
              flush=True)
        return
    flash = sum(_device_us(e) for e in events if "flash_fwd" in e.key)
    print(f"  profile, {n} requests of {batch[0].shape[0]} rows: wall "
          f"{wall_us / n / 1e3:.3f} ms/request, device busy "
          f"{total / n / 1e3:.3f} ms/request ({100 * total / wall_us:.1f}% "
          f"of wall), flash_fwd {flash / n / 1e3:.3f} ms/request "
          f"({100 * flash / total:.1f}% of device time)", flush=True)
    for e in sorted(events, key=_device_us, reverse=True)[:6]:
        print(f"    {_device_us(e) / n / 1e3:8.3f} ms/request  "
              f"x{e.count // n:<3d} {e.key[:90]}", flush=True)


def serve_phase(torch, fa, card, cfg, device):
    """Phase 3: the port's Server on ``cfg`` (BERT-base) on ``device``;
    returns the kernel's launches on the main path."""
    from autodist_tpu_torch import serve
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.utils.tree import leaves

    seq = cfg.max_len
    print(f"phase 3: serve.Server on a {cfg.num_layers}-layer, width "
          f"{cfg.dim} BERT at seq {seq}, buckets (4, 8)", flush=True)
    t0 = time.perf_counter()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
    print(f"  init: {sum(t.numel() for t in leaves(params)) / 1e6:.1f}M "
          f"params in {time.perf_counter() - t0:.1f}s", flush=True)
    before = [t.clone() for t in leaves(params)]

    def apply_fn(p, batch):
        ids, seg = batch
        return T.encode(p, cfg, ids, segment_ids=seg).float()

    ids, seg, _, _ = bert.synthetic_batch(cfg, 8, seq, seed=0)
    rng = np.random.RandomState(1)
    requests = []
    for _ in range(16):
        rows = int(rng.randint(1, 9))
        requests.append((rng.randint(0, cfg.vocab, (rows, seq)).astype(np.int32),
                         rng.randint(0, 2, (rows, seq)).astype(np.int32)))
    answers = [None] * len(requests)
    latencies = [None] * len(requests)

    fa.flash_fwd.launches = 0  # main path: engine build (warm-ups) + serving
    t0 = time.perf_counter()
    srv = serve.Server(apply_fn, params, (ids, seg), buckets=(4, 8),
                       max_wait_ms=5, device=device)
    try:
        warmups = len(srv.engine.buckets)
        print(f"  engine built (capture, strategy, placement, {warmups} "
              f"bucket warm-ups) in {time.perf_counter() - t0:.1f}s",
              flush=True)

        def client(c):
            for i in range(c, len(requests), 4):
                t = time.perf_counter()
                answers[i] = srv.submit(requests[i]).result(timeout=300)
                latencies[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "clients hung")
        check(all(a is not None for a in answers), "a request got no answer")
        repeat = [srv.infer(requests[0], timeout=300) for _ in range(2)]
        stats = srv.stats()
        launches = fa.flash_fwd.launches
        replays = sum(g.replays for g in bucket_graphs(srv.engine).values())
        if device == "cuda":
            profile_dispatches(torch, srv, (ids, seg))
    finally:
        srv.close()
    dispatches = sum(r["dispatches"] for r in stats["replicas"])
    print(f"  {stats['completed']} requests in {stats['batches']} batches, "
          f"{dispatches} dispatches + {warmups} warm-ups; flash_fwd "
          f"launches {launches}", flush=True)
    check(stats["completed"] == len(requests) + 2, "requests lost")
    if device == "cuda":
        check(replays == dispatches, f"{dispatches} dispatches but "
              f"{replays} bucket graph replays")
    check(launches == cfg.num_layers * (dispatches + warmups),
          f"flash_fwd launched {launches} times, expected "
          f"{cfg.num_layers} x ({dispatches} dispatches + {warmups} "
          f"warm-ups): some attention did not run the kernel")
    check(torch.equal(repeat[0], repeat[1]),
          "a repeated request is not bitwise identical")
    check(all(torch.equal(a, b) for a, b in zip(before, leaves(params))),
          "serving changed the params")

    def plain_attn(q, k, v, mask=None):
        return fa.flash_fwd_reference(q, k, v, cfg.causal)[0]

    worst = 0.0
    with torch.inference_mode():
        for (rid, rseg), out in zip(requests, answers):
            ref = T.encode(params, cfg, torch.as_tensor(rid, device=device),
                           segment_ids=torch.as_tensor(rseg, device=device),
                           attn_fn=plain_attn).float().cpu()
            check(out.shape == (rid.shape[0], seq, cfg.dim),
                  f"answer shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "non-finite answer")
            err = (out - ref).abs().max().item()
            worst = max(worst, err)
            check(torch.allclose(out, ref, atol=SERVE_ATOL, rtol=SERVE_RTOL),
                  f"served answer differs from the plain forward by {err}")
    p50, p99 = np.percentile(latencies, 50), np.percentile(latencies, 99)
    print(f"  answers vs plain forward: max abs err {worst:.3e} "
          f"(atol {SERVE_ATOL}, rtol {SERVE_RTOL})", flush=True)
    print(f"  request latency (client, 4 threads, rows 1-8, seq {seq}): "
          f"p50 {p50:.3f} ms, p99 {p99:.3f} ms on {card}", flush=True)
    return launches


def _profile_step(torch, step, n=1):
    """Device time by kernel over ``n`` calls of ``step`` under
    ``torch.profiler``: (wall us, device-busy us, [(us, count, name)])."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_events(prof)
    return wall_us, sum(_device_us(e) for e in events), sorted(
        ((_device_us(e), e.count, e.key) for e in events), reverse=True)


def train_phase(torch, fa, card, cfg, device, steps=20, batch_size=32,
                seq=128, num_masked=20):
    """Phase 4: BERT MLM pretraining through AutoDist -> Runner.step on a
    one-rank world; returns {kernel name: launches on the main path}."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

    print(f"phase 4: training a {cfg.num_layers}-layer, width {cfg.dim} BERT "
          f"(MLM, batch {batch_size} x seq {seq}, {num_masked} masked, Adam "
          f"1e-4) for {steps} Runner.steps through AutoDist(AllReduce())",
          flush=True)
    t0 = time.perf_counter()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
    batch = bert.synthetic_batch(cfg, batch_size, seq, num_masked, seed=0)
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    try:
        item = ad.capture(bert.make_loss_fn(cfg), params,
                          functools.partial(torch.optim.Adam, lr=1e-4),
                          example_batch=batch)
        runner = ad.create_distributed_session(item)
        state = runner.create_state()
        backend = torch.distributed.get_backend()
        mesh = dict(runner.program.mesh.shape)
        print(f"  set-up (init, capture, world, strategy, transform, state) "
              f"{time.perf_counter() - t0:.1f}s: {backend} world of "
              f"{torch.distributed.get_world_size()}, mesh {mesh}, "
              f"{len(runner.bucket_plan())} gradient bucket(s)", flush=True)
        if device == "cuda":
            check(backend == "nccl", f"the world's backend is {backend}")
        dbatch = runner.remapper.shard_batch(batch)
        named = [(path_to_name(p), t)
                 for p, t in flatten_with_path(state.params)[0]]
        leaves = [t for _, t in named]

        def grads_at(attn_fn, c=cfg):
            loss = bert.make_loss_fn(c, attn_fn=attn_fn)(state.params, dbatch)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        def plain_attn(q, k, v, mask=None):
            return fa.flash_fwd_reference(q, k, v, cfg.causal)[0]

        # Step 1 against the plain attention, before the run, and both
        # against the same model computing in f32.
        loss_k, grads_k = grads_at(None)
        loss_p, grads_p = grads_at(plain_attn)
        cfg32 = copy.copy(cfg)
        cfg32.dtype = torch.float32
        _, grads_t = grads_at(plain_attn, cfg32)
        norm_k = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads_k])).item()
        norm_p = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads_p])).item()
        dloss = abs(loss_k.item() - loss_p.item())
        proj = [i for i, (n, _) in enumerate(named)
                if "/attn/" in n and n.endswith(("query/kernel", "key/kernel",
                                                 "value/kernel"))]

        def worst(a, b):  # max over the projections, relative to b's max
            return max(((a[i] - b[i]).abs().max() / b[i].abs().max()).item()
                       for i in proj)
        apart, k_f32, p_f32 = (worst(grads_k, grads_p),
                               worst(grads_k, grads_t),
                               worst(grads_p, grads_t))
        print(f"  step 1 vs plain attention: loss {loss_k.item():.6f} vs "
              f"{loss_p.item():.6f} (|diff| {dloss:.3e}, atol "
              f"{TRAIN_LOSS_ATOL}); grad norm {norm_k:.6f} vs {norm_p:.6f} "
              f"(rel {abs(norm_k - norm_p) / norm_p:.3e}, rtol "
              f"{TRAIN_NORM_RTOL}); attention q/k/v kernels' grads, max "
              f"|diff| / max |grad|: kernels vs plain {apart:.3e} (tol "
              f"{TRAIN_LEAF_REL}), vs the f32 model: kernels {k_f32:.3e}, "
              f"plain {p_f32:.3e} (kernels within {TRAIN_F32_RATIO}x plain)",
              flush=True)
        check(dloss <= TRAIN_LOSS_ATOL, f"step-1 loss differs by {dloss}")
        check(abs(norm_k - norm_p) <= TRAIN_NORM_RTOL * norm_p,
              f"step-1 grad norm {norm_k} vs {norm_p}")
        check(apart <= TRAIN_LEAF_REL, f"attention projection grads differ "
              f"by {apart} of their max")
        check(k_f32 <= TRAIN_F32_RATIO * p_f32, f"attention projection "
              f"grads are {k_f32} off the f32 model, the plain path {p_f32}")
        del grads_k, grads_p, grads_t

        # A repeated attention backward at layer 0's own inputs: bitwise.
        seen = {}

        def recording_attn(q, k, v, mask=None):
            seen.setdefault("qkv", (q.detach(), k.detach(), v.detach()))
            return fa.flash_attention(q, k, v, cfg.causal)
        with torch.no_grad():
            bert.make_loss_fn(cfg, attn_fn=recording_attn)(state.params,
                                                           dbatch)
        qkv = [t.clone().requires_grad_() for t in seen["qkv"]]
        out = fa.flash_attention(*qkv, cfg.causal)
        do = torch.randn(out.shape, generator=torch.Generator(
            device=device).manual_seed(2), device=device, dtype=out.dtype)
        first = torch.autograd.grad(out, qkv, do, retain_graph=True)
        second = torch.autograd.grad(out, qkv, do, retain_graph=True)
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              "a repeated attention backward is not bitwise identical")
        print(f"  repeated attention backward at layer 0's inputs "
              f"{tuple(out.shape)}: bitwise identical", flush=True)
        if device == "cuda":
            # The training forward of one attention: one kernel writes the
            # saved f32 o and the model's bf16 o; no cast follows it.
            fwd = timed(torch, lambda: fa.flash_attention(*qkv, cfg.causal),
                        n=5, warmup=1)
            check(len(fwd["kernels"]) == 1 and
                  all("flash_fwd" in n and 0 < c <= 1
                      for n, c in fwd["kernels"].items()),
                  f"one training attention forward launched "
                  f"{kernel_names(fwd)}, not one flash_fwd kernel")
            print(f"  one training attention forward (_FlashAttention."
                  f"forward) launches {kernel_names(fwd)} and nothing else",
                  flush=True)
            # Its backward: delta = rowsum(do * o) (PyTorch), then each
            # backward kernel once, writing the bf16 gradients: no cast.
            bwd = timed(torch, lambda: torch.autograd.grad(
                out, qkv, do, retain_graph=True), n=5, warmup=1)
            for kernel in ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"):
                hits = [c for n, c in bwd["kernels"].items() if kernel in n]
                check(len(hits) == 1 and 0 < hits[0] <= 1,
                      f"one training attention backward launched "
                      f"{kernel_names(bwd)}: not one {kernel}")
            check(not any(CAST_KERNEL in n for n in bwd["kernels"]),
                  f"one training attention backward casts: "
                  f"{kernel_names(bwd)}")
            print(f"  one training attention backward (_FlashAttention."
                  f"backward under torch.autograd.grad) launches "
                  f"{kernel_names(bwd)}", flush=True)

        before = [t.detach().clone() for t in leaves]
        kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
        for k in kernels:  # the main path: 20 steps
            k.launches = 0
        sync = torch.cuda.synchronize if device == "cuda" else (
            lambda: None)
        losses, times = [], []
        for i in range(steps):
            t = time.perf_counter()
            state, metrics = runner.step(state, batch)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(metrics["loss"])
            if i == 0:
                unchanged = [n for (n, _), b, (_, now) in zip(
                    named, before, flatten_with_path(state.params)[0])
                    if torch.equal(b, now.detach())]
        launches = {k.__name__: k.launches for k in kernels}
        losses = [float(x) for x in losses]
        print(f"  losses: {losses[0]:.6f} (step 1) ... {losses[-1]:.6f} "
              f"(step {steps}); all: " +
              ", ".join(f"{x:.4f}" for x in losses), flush=True)
        check(all(np.isfinite(losses)), "a loss is not finite")
        check(losses[-1] < losses[0], "the loss did not fall")
        check(not unchanged, f"step 1 left params unchanged: {unchanged}")
        print(f"  launches over {steps} steps: {launches}", flush=True)
        for name, n in launches.items():
            check(n == cfg.num_layers * steps,
                  f"{name} launched {n} times, expected {cfg.num_layers} x "
                  f"{steps}: some attention did not run the kernel")
        steady = times[4:]
        med = float(np.median(steady))
        print(f"  step time, median of steps 5-{steps}: {med:.3f} ms "
              f"(min {min(steady):.3f}, max {max(steady):.3f}; step 1 "
              f"{times[0]:.3f} ms), {batch_size / med * 1e3:.1f} samples/s "
              f"on {card}", flush=True)

        if device != "cuda":
            return launches

        def one_step():
            nonlocal state
            state, _ = runner.step(state, batch)
        wall, busy, rows = _profile_step(torch, one_step)
        flash = sum(us for us, _, name in rows if "flash_" in name)
        by_kernel = {k: (sum(us for us, _, name in rows if k in name),
                         sum(n for _, n, name in rows if k in name))
                     for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        for k, (_, n) in by_kernel.items():
            check(n == cfg.num_layers, f"the profiled step launched {k} {n} "
                  f"times, not {cfg.num_layers}")
        casts = sum(n for _, n, name in rows if CAST_KERNEL in name)
        print(f"  profiled step: wall {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / wall:.1f}% of wall), "
              f"flash kernels {flash / 1e3:.3f} ms ({100 * flash / busy:.1f}%"
              f" of device time: " + ", ".join(
                  f"{k} {us / 1e3:.3f} ms x{n}"
                  for k, (us, n) in by_kernel.items()) +
              f") on {card}", flush=True)
        print(f"  f32 -> bf16 cast kernels ({CAST_KERNEL}) in the step: "
              f"{casts}; a backward writing f32 gradients adds one per "
              f"gradient and layer, {3 * cfg.num_layers}", flush=True)
        for us, count, name in rows[:8]:
            print(f"    {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}",
                  flush=True)
    finally:
        autodist_mod._reset_default()
    return launches


def _zoo_world(torch, device):
    """A fresh AutoDist(AllReduce(chunk_size=128)) on ``device`` (the
    previous one, with its world, reset first)."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    autodist_mod._reset_default()
    return AutoDist(strategy_builder=AllReduce(chunk_size=128), device=device)


def _flash_counts(fa, reset=False):
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    if reset:
        for k in kernels:
            k.launches = 0
    return {k.__name__: k.launches for k in kernels}


def _run_steps(torch, fa, step_fn, state, batch, steps, device, named=()):
    """``steps`` calls of the bare step on ``batch``: (state, losses, host
    ms per step, flash launches). Checks finite, falling losses, no flash
    launch, and that step 1 changed every param of ``named`` ((name,
    tensor) pairs of the state, which the step updates in place)."""
    before = [t.detach().clone() for _, t in named]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    _flash_counts(fa, reset=True)  # the main path of this run
    losses, times, unchanged = [], [], []
    for i in range(steps):
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"])
        if i == 0:
            unchanged = [n for (n, t), b in zip(named, before)
                         if torch.equal(b, t.detach())]
    launches = _flash_counts(fa)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(not unchanged, f"step 1 left params unchanged: {unchanged}")
    check(not any(launches.values()), f"flash kernels launched in a model "
          f"without attention: {launches}")
    return state, losses, times, launches


def flatten_params(params):
    from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
    return {path_to_name(p): t for p, t in flatten_with_path(params)[0]}


def resnet_run(torch, fa, card, cfg, batch, device, precision, steps):
    """One ResNet training run of phase 5 through AutoDist -> make_callable;
    returns (step-1 loss, flash launches)."""
    from autodist_tpu_torch.models import resnet
    label = f"precision={precision!r}"
    t0 = time.perf_counter()
    params = resnet.init(cfg, torch.Generator().manual_seed(0), device=device)
    ad = _zoo_world(torch, device)
    item = ad.capture(resnet.make_loss_fn(cfg), params,
                      functools.partial(torch.optim.SGD, lr=1e-3),
                      example_batch=batch, precision=precision)
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    step_fn = runner.make_callable(batch)
    dbatch = runner.remapper.shard_batch(batch)  # placed once
    if device == "cuda":
        check(torch.distributed.get_backend() == "nccl", "not an NCCL world")
    print(f"  ResNet {label}: set-up (init, capture, world, strategy, "
          f"transform, state) {time.perf_counter() - t0:.1f}s, "
          f"{len(runner.bucket_plan())} gradient bucket(s) on {card}",
          flush=True)

    # Step 1 against the same model computing in f32 (TF32 off).
    named = sorted(flatten_params(state.params).items())
    leaves = [t for _, t in named]
    loss = item.loss_fn(state.params, dbatch)
    grads = torch.autograd.grad(loss, leaves)
    cfg32 = copy.copy(cfg)
    cfg32.dtype = torch.float32
    loss32 = resnet.make_loss_fn(cfg32)(state.params, dbatch)
    grads32 = torch.autograd.grad(loss32, leaves)
    rel = {n: ((g - g32).abs().max() / g32.abs().max()).item()
           for (n, _), g, g32 in zip(named, grads, grads32)}
    worst = max(rel, key=rel.get)
    flat, flat32 = (torch.cat([g.flatten() for g in gs])
                    for gs in (grads, grads32))
    cos = torch.nn.functional.cosine_similarity(flat, flat32, dim=0).item()
    rel_l2 = ((flat - flat32).norm() / flat32.norm()).item()
    dloss = abs(loss.item() - loss32.item()) / abs(loss32.item())
    print(f"  step 1 vs the f32 model: loss {loss.item():.6f} vs "
          f"{loss32.item():.6f} (rel {dloss:.3e}, rtol {ZOO_LOSS_RTOL}); "
          f"whole gradient: cosine {cos:.4f} (>= {ZOO_GRAD_COS}), relative "
          f"L2 {rel_l2:.4f} (<= {ZOO_GRAD_REL}); per leaf, max |diff| / max "
          f"|grad|: median {float(np.median(list(rel.values()))):.3e}, worst "
          f"{rel[worst]:.3e} ({worst}) on {card}", flush=True)
    check(loss.dtype == torch.float32, f"the loss is {loss.dtype}")
    check(all(g.dtype == torch.float32 for g in grads),
          "a gradient is not float32")
    check(dloss <= ZOO_LOSS_RTOL, f"step-1 loss {loss.item()} vs the f32 "
          f"model's {loss32.item()}")
    check(cos >= ZOO_GRAD_COS and rel_l2 <= ZOO_GRAD_REL, f"step-1 "
          f"gradient vs the f32 model's: cosine {cos}, relative L2 {rel_l2}")
    first = loss.item()
    del loss, grads, loss32, grads32, flat, flat32

    state, losses, times, launches = _run_steps(
        torch, fa, step_fn, state, dbatch, steps, device, named)
    n = dbatch[0].shape[0]
    steady = times[4:] if len(times) > 4 else times
    med = float(np.median(steady))
    print(f"  losses {losses[0]:.6f} (step 1) ... {losses[-1]:.6f} (step "
          f"{steps}); all: " + ", ".join(f"{x:.4f}" for x in losses) +
          f"; flash launches over the {steps} steps: {launches} on {card}",
          flush=True)
    flops = item.flops_estimate()
    print(f"  step time, median of steps 5-{steps}: {med:.3f} ms (min "
          f"{min(steady):.3f}, max {max(steady):.3f}; step 1 {times[0]:.3f} "
          f"ms), {n / med * 1e3:.1f} images/s on {card}", flush=True)
    model_flops = 3 * flops / (med / 1e3)
    print(f"  flops_estimate() {flops / 1e9:.3f} GFLOP per forward at batch "
          f"{n}; model FLOP/s (3 x forward / step time) "
          f"{model_flops / 1e12:.2f} TFLOP/s, "
          f"{100 * model_flops / PEAK_BF16_FLOPS:.2f}% of the dense bf16 "
          f"peak on {card}", flush=True)
    if device == "cuda":
        def one_step():
            nonlocal state
            state, _ = step_fn(state, dbatch)
        wall, busy, rows = _profile_step(torch, one_step)
        transposes = sum(c for _, c, name in rows
                         if any(t in name for t in TRANSPOSE_KERNELS))
        groups = {}
        for us, count, name in rows:
            group = next((g for g, keys in KERNEL_GROUPS if any(
                k in name for k in keys)), "other")
            total, n_k = groups.get(group, (0.0, 0))
            groups[group] = (total + us, n_k + count)
        print(f"  profiled step: wall {wall / 1e3:.3f} ms, device busy "
              f"{busy / 1e3:.3f} ms ({100 * busy / wall:.1f}% of wall); "
              f"layout-transpose kernels ({', '.join(TRANSPOSE_KERNELS)}): "
              f"{transposes}; by kind: " + ", ".join(
                  f"{g} {us / 1e3:.3f} ms x{n_k}" for g, (us, n_k) in
                  sorted(groups.items(), key=lambda kv: -kv[1][0])) +
              f" on {card}", flush=True)
        for us, count, name in rows[:12]:
            print(f"    {us / 1e3:8.3f} ms  x{count:<4d} {name[:90]}",
                  flush=True)
    return first, launches


def zoo_phase(torch, fa, card, device, resnet_cfg=None, image=224,
              batch_size=64, steps=20, bilstm_cfg=None, ncf_cfg=None,
              rnn_steps=5):
    """Phase 5: ResNet-50 with the model's bf16 compute and under
    ``precision="bf16"``, then BiLSTM and NCF, each through AutoDist ->
    make_callable on a one-rank world; returns {path: flash launches}."""
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bilstm, ncf, resnet
    cfg = resnet_cfg or resnet.resnet50()
    batch = resnet.synthetic_batch(batch_size, image, cfg.num_classes)
    print(f"phase 5: the model zoo; ResNet (stages {cfg.stage_sizes}, "
          f"{cfg.num_classes} classes, batch {batch_size} x {image} x {image}"
          f" x 3, SGD 1e-3) for {steps} steps through AutoDist(AllReduce("
          f"chunk_size=128)) -> make_callable", flush=True)
    paths = {}
    try:
        first, paths["zoo_resnet"] = resnet_run(
            torch, fa, card, cfg, batch, device, None, steps)
        first16, paths["zoo_resnet_bf16"] = resnet_run(
            torch, fa, card, cfg, batch, device, "bf16", steps)
        drift = abs(first16 - first) / abs(first)
        print(f"  step-1 loss under precision='bf16' {first16:.6f} vs the "
              f"model's bf16 compute {first:.6f} (rel {drift:.3e}, rtol "
              f"{ZOO_LOSS_RTOL}) on {card}", flush=True)
        check(drift <= ZOO_LOSS_RTOL, "the precision='bf16' step-1 loss is "
              f"{drift} off the model's own")

        for name, mod, mcfg in (
                ("bilstm", bilstm, bilstm_cfg or bilstm.BiLSTMConfig()),
                ("ncf", ncf, ncf_cfg or ncf.NCFConfig())):
            mbatch = (mod.synthetic_batch(mcfg, 64, 128) if name == "bilstm"
                      else mod.synthetic_batch(mcfg, 1024))
            t0 = time.perf_counter()
            params = mod.init(mcfg, torch.Generator().manual_seed(0),
                              device=device)
            ad = _zoo_world(torch, device)
            item = ad.capture(mod.make_loss_fn(mcfg), params,
                              functools.partial(torch.optim.Adam, lr=1e-3),
                              example_batch=mbatch)
            runner = ad.create_distributed_session(item)
            state = runner.create_state()
            sparse = sorted(v.name for v in item.variables
                            if v.sparse_access)
            want = (["embed/embedding"] if name == "bilstm" else
                    sorted(f"embed_{w}_{t}/embedding" for w in ("user", "item")
                           for t in ("gmf", "mlp")))
            check(sparse == want, f"{name}: sparse-access {sparse}")
            dbatch = runner.remapper.shard_batch(mbatch)
            state, losses, times, paths["zoo_" + name] = _run_steps(
                torch, fa, runner.make_callable(mbatch), state, dbatch,
                rnn_steps, device)
            warm = float(np.median(times[1:]))
            print(f"  {name} (batch {tuple(mbatch[0].shape)}, Adam 1e-3): "
                  f"set-up {time.perf_counter() - t0 - sum(times) / 1e3:.1f}"
                  f"s; losses " + ", ".join(f"{x:.4f}" for x in losses) +
                  f"; step ms, median of steps 2-{rnn_steps}: {warm:.3f} "
                  f"(step 1 {times[0]:.3f}); flops_estimate() "
                  f"{item.flops_estimate() / 1e9:.4f} GFLOP; sparse-access "
                  f"{sparse}; flash launches {paths['zoo_' + name]} on "
                  f"{card}", flush=True)
    finally:
        autodist_mod._reset_default()
    return paths


def _lane_inputs(lane, seed):
    """Host (tokens, positions) that fill every slot of ``lane``: random
    tokens at positions spread over the cache."""
    rng = np.random.RandomState(seed)
    vocab = lane.replica.params["embed"]["embedding"].shape[0]
    return (rng.randint(1, vocab, lane.slots).astype(np.int64),
            rng.randint(0, lane.cache_len, lane.slots).astype(np.int64))


def _eager_step(torch, lane):
    """The lane's step without its graph, on the card: the same copies in,
    the step's kernels launched one by one, the ids to the host."""
    def step(tok, pos):
        lane.tokens.copy_(torch.from_numpy(tok))
        lane.pos.copy_(torch.from_numpy(pos))
        ids = lane._compute()[1].cpu()
        torch.cuda.synchronize()
        return ids
    return step


def _teacher_forced(torch, lane, streams):
    """Feed each stream (token list) through its own slot of ``lane``, one
    position per step, from a zeroed cache; returns each stream's logits
    (len, vocab) on the device, rows as the lane computed them."""
    from autodist_tpu_torch.utils.tree import leaves
    for t in leaves(lane.cache):
        t.zero_()
    vocab = lane.replica.params["embed"]["embedding"].shape[0]
    out = [torch.empty((len(st), vocab), device=lane.device)
           for st in streams]
    for s in range(max(len(st) for st in streams)):
        tok = np.zeros(lane.slots, np.int64)
        pos = np.zeros(lane.slots, np.int64)
        for i, st in enumerate(streams):
            if s < len(st):
                tok[i], pos[i] = st[s], s
        lane._run(tok, pos)
        for i, st in enumerate(streams):
            if s < len(st):
                out[i][s] = lane.logits[i]
    return out


def decode_phase(torch, fa, card, cfg, device, buckets=DECODE_BUCKETS,
                 requests=DECODE_REQUESTS, clients=DECODE_CLIENTS,
                 prompt_len=(16, 128), new_tokens=(32, 128)):
    """Phase 6: lm1b decode through serve.DecodeServer, one CUDA graph per
    (slots, cache_len) lane; returns {kernel name: launches on the path}."""
    from autodist_tpu_torch import serve
    from autodist_tpu_torch.models import layers as L
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.utils.tree import leaves

    print(f"phase 6: serve.DecodeServer on a {cfg.num_layers}-layer, width "
          f"{cfg.dim}, vocab {cfg.vocab} causal LM ({str(cfg.dtype)[6:]} "
          f"compute), buckets {list(buckets)}; {requests} requests from "
          f"{clients} closed-loop clients, prompts {prompt_len[0]}-"
          f"{prompt_len[1]} tokens, max_new_tokens {new_tokens[0]}-"
          f"{new_tokens[1]}", flush=True)
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator().manual_seed(0), device=device)
    n_params = sum(t.numel() for t in leaves(params))
    before = [t.clone() for t in leaves(params)]

    def apply_fn(p, batch):
        (tokens,) = batch
        return T.logits(p, cfg, T.encode(p, cfg, tokens))

    rng = np.random.RandomState(1)
    work = [(rng.randint(1, cfg.vocab, int(rng.randint(prompt_len[0],
                                                      prompt_len[1] + 1))),
             int(rng.randint(new_tokens[0], new_tokens[1] + 1)))
            for _ in range(requests)]
    outputs, latencies = [None] * requests, [None] * requests
    _flash_counts(fa, reset=True)  # the main path: server build + traffic
    srv = serve.DecodeServer(
        apply_fn, lm.make_decode_fn(cfg),
        functools.partial(lm.init_decode_cache, cfg), params,
        (np.zeros((8, 16), np.int32),), buckets=buckets, device=device)
    try:
        lanes = srv.engine.replicas[0].lanes
        graphs = [lane.graph is not None for lane in lanes]
        print(f"  init {n_params / 1e6:.1f}M params + server build (capture, "
              f"strategy, placement, {len(lanes)} lanes: caches "
              f"{sum(srv.engine.cache_bytes(*b) for b in buckets) / 1e9:.3f} "
              f"GB, CUDA graphs {graphs}) {time.perf_counter() - t0:.1f}s",
              flush=True)
        if device == "cuda":
            check(all(graphs), "a lane on the card has no CUDA graph")

        def client(c):
            for i in range(c, requests, clients):
                t = time.perf_counter()
                prompt, n_new = work[i]
                outputs[i] = srv.submit(prompt, max_new_tokens=n_new).result(
                    timeout=600)
                latencies[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "decode clients hung")
        stats = srv.stats()
        launches = _flash_counts(fa)
        steps = {f"{ln.slots}x{ln.cache_len}": ln.steps for ln in lanes}
        srv.engine._stop_threads()  # the lanes are driven directly below
        tokens = sum(len(o) for o in outputs)
        check(all(o is not None and len(o) == n for o, (_, n) in
                  zip(outputs, work)), "a request got no answer or the wrong "
              "number of tokens")
        check(stats["completed"] == stats["requests"] == requests and
              stats["tokens"] == tokens and stats["in_flight"] == 0 and
              stats["queue_depth"] == 0,
              f"requests did not complete exactly once: {stats}")
        check(all(0 <= int(x) < cfg.vocab for o in outputs for x in o),
              "a generated token is outside the vocabulary")
        check(not any(launches.values()), f"the decode path launched flash "
              f"kernels: {launches}")
        p50, p99 = np.percentile(latencies, 50), np.percentile(latencies, 99)
        print(f"  {requests} requests, each completed once, {tokens} tokens "
              f"generated in {wall:.3f} s: {tokens / wall:.1f} tokens/s; "
              f"request latency (client) p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
              f"lane steps {steps}; flash launches {launches} on {card}",
              flush=True)

        # Teacher-forced logits vs the port's full-prefix recompute.
        small = lanes[0]
        order = sorted(range(requests), key=lambda i: -len(work[i][0]) -
                       len(outputs[i]))[:DECODE_CHECKED]
        streams = [list(work[i][0]) + [int(x) for x in outputs[i]]
                   for i in order]
        fit = [st[:small.cache_len] for st in streams]
        forced = _teacher_forced(torch, small, fit)
        worst, agree, agree_lane, total = 0.0, 0, 0, 0
        with torch.inference_mode():
            for i, st, got in zip(order, fit, forced):
                ids = torch.zeros((1, small.cache_len), dtype=torch.long,
                                  device=small.device)
                ids[0, :len(st)] = torch.as_tensor(st, device=small.device)
                ref = T.logits(params, cfg, T.encode(
                    params, cfg, ids, attn_fn=L.dot_product_attention))[0]
                ref = ref[:len(st)]
                worst = max(worst, ((got - ref).abs().max() /
                                    ref.abs().max()).item())
                gen = range(len(work[i][0]) - 1, len(st) - 1)
                nxt = torch.as_tensor(st, device=small.device)
                total += len(gen)
                agree += int((ref[gen.start:gen.stop].argmax(-1) ==
                              nxt[gen.start + 1:gen.stop + 1]).sum())
                agree_lane += int((got[gen.start:gen.stop].argmax(-1) ==
                                   nxt[gen.start + 1:gen.stop + 1]).sum())
        print(f"  teacher-forced logits of {len(order)} requests (lengths "
              f"{[len(st) for st in fit]}) vs the full-prefix recompute "
              f"(encode, dense attention, padded to {small.cache_len}): max "
              f"|diff| / max |logit| {worst:.3e} (tol {DECODE_LOGIT_RTOL}); "
              f"served tokens that the recompute's greedy choice agrees "
              f"with: {agree} of {total} (the lane's own teacher-forced "
              f"choice: {agree_lane} of {total})", flush=True)
        check(worst <= DECODE_LOGIT_RTOL, f"decode logits are {worst} of "
              f"their max off the full-prefix recompute")

        # Stale-slot reuse: slot 0 over zeros, and over another request.
        probe, filler = fit[-1][:40], streams[0]
        clean = _teacher_forced(torch, small, [probe])[0].clone()
        for s, t in enumerate(filler[:small.cache_len]):
            tok = np.zeros(small.slots, np.int64)
            pos = np.zeros(small.slots, np.int64)
            tok[0], pos[0] = t, s
            small._run(tok, pos)
        stale = torch.empty_like(clean)
        for s, t in enumerate(probe):
            tok = np.zeros(small.slots, np.int64)
            pos = np.zeros(small.slots, np.int64)
            tok[0], pos[0] = t, s
            small._run(tok, pos)
            stale[s] = small.logits[0]
        check(torch.equal(clean, stale), "a reused slot's logits depend on "
              "the stale rows of its previous occupant")
        print(f"  stale-slot reuse: slot 0's logits over {len(probe)} "
              f"positions bitwise equal over a zeroed cache and over "
              f"{min(len(filler), small.cache_len)} rows of another "
              f"request", flush=True)

        if device == "cuda":
            for lane in lanes:
                decode_lane_timing(torch, card, cfg, lane, n_params)
    finally:
        srv.close()
    check(all(torch.equal(a, b) for a, b in zip(before, leaves(params))),
          "decoding changed the params")
    return launches


def decode_lane_timing(torch, card, cfg, lane, n_params):
    """Phase 6 on the card, one lane: graph replay vs the eager step
    (bitwise, then timed), its bound, and a profiled window of steps."""
    from autodist_tpu_torch.serve.decode import DecodeRequest
    from autodist_tpu_torch.utils.tree import leaves
    label = f"lane {lane.slots}x{lane.cache_len}"
    tok, pos = _lane_inputs(lane, seed=lane.slots)
    eager = _eager_step(torch, lane)
    snapshot = [t.clone() for t in leaves(lane.cache)]
    ids_g = torch.from_numpy(lane._run(tok, pos).copy())
    logits_g = lane.logits.clone()
    cache_g = [t.clone() for t in leaves(lane.cache)]
    for t, s in zip(leaves(lane.cache), snapshot):
        t.copy_(s)
    ids_e = eager(tok, pos)
    check(torch.equal(lane.logits, logits_g) and torch.equal(ids_e, ids_g) and
          all(torch.equal(a, b) for a, b in zip(leaves(lane.cache), cache_g)),
          f"{label}: the graph replay is not bitwise the eager step")
    check(torch.equal(ids_g, torch.from_numpy(
        lane.logits.float().cpu().numpy().argmax(-1))),
          f"{label}: the ids are not np.argmax of the logits")
    del snapshot, cache_g
    print(f"  {label}: graph replay == eager step, bitwise (logits, ids, "
          f"cache); ids == np.argmax(logits)", flush=True)
    # Bound: the params (f32, read once) and the whole cache (read once),
    # against 2 flops per param and token plus attention over the cache.
    hd = cfg.dim // cfg.num_heads
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(lane.cache))
    flops = (2.0 * n_params * lane.slots + 4.0 * lane.slots * cfg.num_layers *
             cfg.num_heads * lane.cache_len * hd)
    bound_ms, bound_by = bound(flops, 4.0 * n_params + cache_bytes)
    graph = timed(torch, lambda: lane._run(tok, pos))
    plain = timed(torch, lambda: eager(tok, pos))
    print(f"  {label}, all {lane.slots} slots busy: device ms per step "
          f"(profiler, {TIMED_CALLS} steps) / host-inclusive ms per step "
          f"(events): graph {graph['ms']:.4f} / {graph['host_ms']:.4f}, eager "
          f"{plain['ms']:.4f} / {plain['host_ms']:.4f}; bound {bound_ms:.4f} "
          f"({bound_by}: {4.0 * n_params / 1e9:.3f} GB f32 params + "
          f"{cache_bytes / 1e9:.3f} GB cache, {flops / 1e9:.1f} GFLOP); bound "
          f"/ graph device {bound_ms / graph['ms']:.3f}; "
          f"{lane.slots / graph['host_ms'] * 1e3:.1f} tokens/s at the graph's "
          f"host-inclusive step on {card}", flush=True)
    print(f"    kernels per graph step: {sum(graph['kernels'].values()):.0f}"
          f", per eager step: {sum(plain['kernels'].values()):.0f}",
          flush=True)
    # A window of 30 steps through lane.step (slot bookkeeping included).
    rng = np.random.RandomState(2)
    for i in range(lane.slots):
        lane.place(DecodeRequest(-1 - i, rng.randint(1, cfg.vocab, 8),
                                 lane.cache_len - 8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(30):
        lane.step()
    plain_wall = (time.perf_counter() - t0) * 1e6  # us, as the profile's
    wall, busy, rows = _profile_step(torch, lane.step, n=30)
    lane.evict_all()
    print(f"  {label}: 30 steps through the lane (all slots busy, slot "
          f"bookkeeping included): wall {plain_wall / 30e3:.4f} ms/step "
          f"unprofiled, {wall / 30e3:.4f} profiled; device busy "
          f"{busy / 30e3:.4f} ms/step ({100 * busy / plain_wall:.1f}% of the "
          f"unprofiled wall, {100 * busy / wall:.1f}% of the profiled) on "
          f"{card}", flush=True)
    for us, count, name in rows[:6]:
        print(f"    {us / 30e3:8.4f} ms/step  x{count / 30:<5.1f} "
              f"{name[:90]}", flush=True)


def _state_tensors(torch, state):
    """Every tensor a step updates in place: the params and the
    optimizer's state."""
    from autodist_tpu_torch.utils.tree import leaves
    out = list(leaves(state.params))
    for st in state.opt_state.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def _busy_window(torch, step, n=BUSY_WINDOW):
    """(unprofiled wall ms per step, device-busy ms per step) over ``n``
    calls of ``step``: the wall with no profiler (a profiler's own cost on
    a replayed graph distorts it), the busy time from a profiled window."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    _, busy, rows = _profile_step(torch, step, n=n)
    return wall, busy / 1e3 / n, rows


def _drive(torch, fa, step_fn, state, batch, steps, device, first=None):
    """``steps`` calls of ``step_fn`` from ``state``: (state, losses, host
    ms per step, flash launches counted over the calls, the params after
    step 1 as clones). ``first`` (the eager path's params after step 1)
    is compared, and only then are this path's kept."""
    from autodist_tpu_torch.utils.tree import leaves
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    _flash_counts(fa, reset=True)  # this path's run
    losses, times, after1 = [], [], None
    for i in range(steps):
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(metrics["loss"])
        if i == 0:
            now = [t.detach() for t in leaves(state.params)]
            after1 = (max((a - b).abs().max().item()
                          for a, b in zip(now, first)) if first is not None
                      else [t.clone() for t in now])
    launches = _flash_counts(fa)
    return state, [float(x) for x in losses], times, launches, after1


def graph_train_run(torch, fa, card, label, runner, batch, steps, device,
                    per_step, flops=None, unroll=None):
    """Phase 7 for one model: the same initial state stepped ``steps``
    times eagerly (``make_callable(batch)``), through
    ``make_callable(batch, aot=True)`` and, with ``unroll``, through
    ``run(..., steps, unroll=unroll)``. Checks the graph paths against the
    eager one and that they replayed their graphs; returns {path: flash
    launches}."""
    dbatch = runner.remapper.shard_batch(batch)  # placed once
    out = {}
    state, eager, times_e, out["eager"], first = _drive(
        torch, fa, runner.make_callable(batch), runner.create_state(),
        dbatch, steps, device)
    check(all(np.isfinite(eager)) and eager[-1] < eager[0],
          f"{label}: eager losses {eager}")
    del state
    aot = runner.make_callable(batch, aot=True)
    state, graphed, times_g, out["aot"], diff1 = _drive(
        torch, fa, aot, runner.create_state(), dbatch, steps, device,
        first=first)
    del first
    rel = [abs(g - e) / abs(e) for g, e in zip(graphed, eager)]
    print(f"  {label}: losses eager {eager[0]:.6f} ... {eager[-1]:.6f}, "
          f"make_callable(aot=True) {graphed[0]:.6f} ... {graphed[-1]:.6f}; "
          f"step 1 loss bitwise equal: {graphed[0] == eager[0]}; max |param "
          f"difference| after step 1 {diff1:.3e}; per-step loss rel. diff "
          f"max {max(rel):.3e} (tol {GRAPH_LOSS_RTOL})", flush=True)
    check(graphed[0] == eager[0], f"{label}: step-1 loss {graphed[0]} vs "
          f"the eager step's {eager[0]}")
    check(max(rel) <= GRAPH_LOSS_RTOL, f"{label}: the aot losses {graphed} "
          f"are off the eager ones {eager}")
    if device == "cuda":
        check(aot.graph.captured and aot.graph.replays == steps - 1,
              f"{label}: make_callable(aot=True) replayed its graph "
              f"{aot.graph.replays} times in {steps} calls")

    # A replay and an eager step from the same state: the loss (computed
    # before the update) bitwise; the params' difference printed.
    tensors = _state_tensors(torch, state)
    snap = [t.detach().clone() for t in tensors]
    state, m_g = aot(state, dbatch)
    after_g = [t.detach().clone() for t in tensors]
    with torch.no_grad():
        for t, v in zip(tensors, snap):
            t.copy_(v)
    state, m_e = runner.make_callable(batch)(state, dbatch)
    pdiff = max((a - t).abs().max().item() for a, t in zip(after_g, tensors))
    print(f"  {label}: one graph replay vs one eager step from the same "
          f"state: loss {float(m_g['loss']):.6f} vs {float(m_e['loss']):.6f}"
          f" (bitwise equal: {bool(torch.equal(m_g['loss'], m_e['loss']))})"
          f", max |state difference| after it {pdiff:.3e}", flush=True)
    check(torch.equal(m_g["loss"], m_e["loss"]), f"{label}: a replay's loss "
          f"is not bitwise the eager step's from the same state")
    del snap, after_g, tensors

    def rate(times):
        steady = times[4:] if len(times) > 4 else times
        med = float(np.median(steady))
        return med, per_step / med * 1e3
    for name, times in (("eager", times_e), ("aot", times_g)):
        med, r = rate(times)
        extra = ""
        if flops:
            tf = 3 * flops / (med / 1e3)
            extra = (f", model FLOP/s {tf / 1e12:.2f} TFLOP/s = "
                     f"{100 * tf / PEAK_BF16_FLOPS:.2f}% of the dense bf16 "
                     f"peak")
        print(f"  {label} {name}: step time, median of steps 5-{steps}: "
              f"{med:.3f} ms (min {min(times[4:]):.3f}, max "
              f"{max(times[4:]):.3f}; step 1 {times[0]:.3f} ms), {r:.1f} "
              f"{'images' if flops else 'samples'}/s{extra} on {card}",
              flush=True)
    if device == "cuda":
        fns = {"eager": runner.make_callable(batch), "aot": aot}
        for name, fn in fns.items():
            def one_step(fn=fn):
                nonlocal state
                state, _ = fn(state, dbatch)
            wall, busy, rows = _busy_window(torch, one_step)
            print(f"  {label} {name}: {BUSY_WINDOW} steps unprofiled "
                  f"{wall:.3f} ms/step, device busy {busy:.3f} ms/step "
                  f"({100 * busy / wall:.1f}% of the unprofiled wall); "
                  f"kernels per step {sum(c for _, c, _ in rows) / BUSY_WINDOW:.0f}"
                  f" on {card}", flush=True)
            for us, count, kname in rows[:5]:
                print(f"    {us / 1e3 / BUSY_WINDOW:8.3f} ms/step  "
                      f"x{count / BUSY_WINDOW:<5.1f} {kname[:90]}",
                      flush=True)
    del state

    if unroll:
        state = runner.create_state()
        _flash_counts(fa, reset=True)  # this path's run
        t = time.perf_counter()
        state, m = runner.run(state, iter([dbatch] * steps), steps,
                              unroll=unroll)
        losses = [float(x) for x in m["loss"]]
        out[f"unroll{unroll}"] = _flash_counts(fa)
        first_ms = (time.perf_counter() - t) * 1e3
        graph = next(iter(runner._graphs.values())).graph
        rel = [abs(g - e) / abs(e) for g, e in zip(losses,
                                                   eager[-unroll:])]
        check(int(state.step) == steps and tuple(m["loss"].shape) ==
              (unroll,) and not bool(m["notfinite"]),
              f"{label}: run(unroll={unroll}) ended at step "
              f"{int(state.step)} with metrics {m}")
        check(max(rel) <= GRAPH_LOSS_RTOL, f"{label}: run(unroll={unroll})'s "
              f"last losses {losses} are off the eager ones "
              f"{eager[-unroll:]}")
        if device == "cuda":
            check(graph.captured and graph.replays == steps // unroll - 1,
                  f"{label}: run(unroll={unroll}) replayed its graph "
                  f"{graph.replays} times in {steps // unroll} dispatches")
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = runner.run(state, iter([dbatch] * steps), steps,
                              unroll=unroll)
        if device == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / steps
        print(f"  {label} run({steps} steps, unroll={unroll}): last losses "
              f"{', '.join(f'{x:.4f}' for x in losses)} (eager steps "
              f"{steps - unroll + 1}-{steps} rel. diff max {max(rel):.3e}); "
              f"{first_ms:.1f} ms with its capture; again, all graphs: "
              f"{ms:.3f} ms/step, {per_step / ms * 1e3:.1f} "
              f"{'images' if flops else 'samples'}/s on {card}", flush=True)
        del state
    return out


def graph_phase(torch, fa, card, bert_cfg, resnet_cfg, device, image=224,
                bert_batch=32, seq=128, num_masked=20, resnet_batch=64,
                steps=20, unroll=GRAPH_UNROLL):
    """Phase 7: the training step as CUDA graphs: BERT MLM (Adam 1e-4,
    ``AllReduce()``) eager / ``make_callable(aot=True)`` / ``run(unroll)``,
    then ResNet (SGD 1e-3, ``AllReduce(chunk_size=128)``) eager / aot with
    the model's bf16 compute and under ``precision="bf16"``; returns
    {path: flash launches}."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert, resnet
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    print(f"phase 7: the step as CUDA graphs; a {bert_cfg.num_layers}-layer "
          f"BERT (MLM, batch {bert_batch} x {seq}, Adam 1e-4) and ResNet "
          f"(stages {resnet_cfg.stage_sizes}, batch {resnet_batch} x {image}"
          f"^2, SGD 1e-3), {steps} steps a path", flush=True)
    paths = {}
    try:
        autodist_mod._reset_default()
        t0 = time.perf_counter()
        params = bert.init(bert_cfg, torch.Generator().manual_seed(0),
                           device=device)
        batch = bert.synthetic_batch(bert_cfg, bert_batch, seq, num_masked,
                                     seed=0)
        ad = AutoDist(strategy_builder=AllReduce(), device=device)
        runner = ad.create_distributed_session(ad.capture(
            bert.make_loss_fn(bert_cfg), params,
            functools.partial(torch.optim.Adam, lr=1e-4),
            example_batch=batch))
        del params
        if device == "cuda":
            check(torch.distributed.get_backend() == "nccl",
                  "not an NCCL world")
        print(f"  BERT set-up {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        got = graph_train_run(torch, fa, card, "BERT", runner, batch, steps,
                              device, bert_batch, unroll=unroll)
        print(f"  BERT paths {time.perf_counter() - t0:.1f}s", flush=True)
        for path, counts in got.items():
            for name, n in counts.items():
                check(n == bert_cfg.num_layers * steps,
                      f"BERT {path}: {name} launched {n} times, expected "
                      f"{bert_cfg.num_layers} x {steps}")
            paths["graph_bert_" + path] = counts
        print(f"  BERT flash launches by path (eager warm-up + replays on "
              f"the graph paths): {got}", flush=True)
        del runner
        for precision in (None, "bf16"):
            ad = _zoo_world(torch, device)
            rbatch = resnet.synthetic_batch(resnet_batch, image,
                                            resnet_cfg.num_classes)
            item = ad.capture(resnet.make_loss_fn(resnet_cfg),
                              resnet.init(resnet_cfg,
                                          torch.Generator().manual_seed(0),
                                          device=device),
                              functools.partial(torch.optim.SGD, lr=1e-3),
                              example_batch=rbatch, precision=precision)
            runner = ad.create_distributed_session(item)
            label = f"ResNet precision={precision!r}"
            t0 = time.perf_counter()
            got = graph_train_run(torch, fa, card, label, runner, rbatch,
                                  steps, device, resnet_batch,
                                  flops=item.flops_estimate())
            print(f"  {label} paths {time.perf_counter() - t0:.1f}s",
                  flush=True)
            for path, counts in got.items():
                check(not any(counts.values()), f"{label} {path}: flash "
                      f"kernels launched in a model without attention: "
                      f"{counts}")
                paths[f"graph_resnet{'_bf16' if precision else ''}_"
                      f"{path}"] = counts
            del runner, item
    finally:
        autodist_mod._reset_default()
    return paths


def strategy_run(torch, fa, cfg, device, label, builder, batch, steps,
                 aot=False, kinds=("ar",), backend="nccl", optimizer="Adam",
                 lr=1e-4):
    """``steps`` steps of BERT under one builder, eagerly or through
    ``make_callable(aot=True)``: checks the lowering (the set of variable
    kinds: on one rank every variable takes the replicated update, a stale
    one the local update), finite falling losses, every param changed and
    a launch of each flash kernel per layer and step; returns the losses,
    flash launches, host ms per step, runner, state, step function, and
    the initial and final logical params by name. The world is a fresh
    one-rank world unless the caller started one; BERT MLM (``optimizer``
    of ``torch.optim`` at ``lr``) from the seeded init; ``builder`` None
    is ``AutoDist()``'s default."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    autodist_mod._reset_default()
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
    ad = AutoDist(strategy_builder=builder, device=device)
    runner = ad.create_distributed_session(ad.capture(
        bert.make_loss_fn(cfg), params,
        functools.partial(getattr(torch.optim, optimizer), lr=lr),
        example_batch=batch))
    if device == "cuda":
        world = torch.distributed.get_backend()
        check(world == backend, f"{label}: a {world} world, not {backend}")
    init = flatten_params(params)
    del params
    got = {k for k, _ in runner.var_kinds.values()}
    check(got == set(kinds), f"{label}: variable kinds {got}, expected "
          f"{set(kinds)}")
    if runner.program.data_axis_size == 1:
        check(not runner.program.paddings(), f"{label}: padded storage on "
              f"a one-rank world")
    dbatch = runner.remapper.shard_batch(batch)
    step_fn = runner.make_callable(batch, aot=aot)
    state, losses, times, launches, _ = _drive(
        torch, fa, step_fn, runner.create_state(), dbatch, steps, device)
    after = flatten_params(runner.logical_params(state))
    unchanged = [n for n, t in init.items() if torch.equal(t, after[n])]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: losses {losses}")
    check(not unchanged, f"{label}: params unchanged: {unchanged}")
    for name, n in launches.items():
        check(n == cfg.num_layers * steps, f"{label}: {name} launched {n} "
              f"times, expected {cfg.num_layers} x {steps}")
    if aot and device == "cuda":
        check(step_fn.graph.captured and step_fn.graph.replays == steps - 1,
              f"{label}: the aot step replayed {step_fn.graph.replays} "
              f"times in {steps} calls")
    return types.SimpleNamespace(
        losses=losses, launches=launches, times=times, runner=runner,
        state=state, step_fn=step_fn, init=init, params=after)


def update_error(torch, got, ref, init):
    """The relative L2 error of a run's whole update, ||got - ref|| /
    ||ref - init|| over all params (by name) together. Unlike the loss
    under Adam, it sees a gradient off by a constant factor under SGD.
    Not per param: some gradients are zero but for roundings (the
    attention key bias shifts each score row by a constant, which the
    softmax cancels), and their updates are all noise."""
    diff = sum(float((got[n].float() - ref[n].float()).square().sum())
               for n in ref)
    step = sum(float((ref[n].float() - init[n].float()).square().sum())
               for n in ref)
    return (diff / step) ** 0.5


def strategy_phase(torch, fa, card, cfg, device, batch_size=32, seq=128,
                   num_masked=20, steps=STRATEGY_STEPS,
                   graph_steps=STRATEGY_GRAPH_STEPS):
    """Phase 8: BERT MLM under every ported strategy builder on a one-rank
    world, each run from the seeded init on the same batch: eagerly under
    ``AutoDist()`` (PS) and the other builders, held to ``AllReduce()``'s
    eager steps; ``Parallax()`` (BASELINE's BERT configuration) through
    ``make_callable(aot=True)``, held to ``AllReduce()``'s aot steps, and
    both timed. Returns {path: flash launches}."""
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import bert
    print(f"phase 8: strategy builders; a {cfg.num_layers}-layer, width "
          f"{cfg.dim} BERT (MLM, batch {batch_size} x {seq}, Adam 1e-4) on "
          f"a one-rank world, {steps} eager steps a builder, {graph_steps} "
          f"aot steps for AllReduce and Parallax", flush=True)
    batch = bert.synthetic_batch(cfg, batch_size, seq, num_masked, seed=0)
    env = os.environ.pop("AUTODIST_STRATEGY", None)  # AutoDist() -> PS()
    paths = {}

    def rel_diff(losses, ref):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, ref))

    def held(label, losses, ref, rtol):
        rel = rel_diff(losses, ref)
        print(f"  {label}: losses {', '.join(f'{x:.6f}' for x in losses)}; "
              f"step 1 bitwise AllReduce's: {losses[0] == ref[0]}, max rel. "
              f"diff {rel:.3e} (tol {rtol})", flush=True)
        check(losses[0] == ref[0], f"{label}: step-1 loss {losses[0]} vs "
              f"AllReduce's {ref[0]}")
        check(rel <= rtol, f"{label}: losses {losses} vs AllReduce's {ref}")

    def bracket(label, ref, aot, rtol):
        """AllReduce() again (the floor: two runs of one program) and at
        twice the learning rate (a planted fault: the update doubled),
        both against ``ref``: the tolerance must lie between them."""
        runs = [strategy_run(torch, fa, cfg, device, f"AllReduce() {label}"
                             f"{tag}", S.AllReduce(), batch,
                             len(ref), aot=aot, lr=lr).losses
                for tag, lr in (("", 1e-4), (" at lr 2e-4", 2e-4))]
        floor, fault = (rel_diff(r, ref) for r in runs)
        print(f"  AllReduce() {label}: again from the same init max rel. "
              f"diff {floor:.3e}, at lr 2e-4 (the update doubled) "
              f"{fault:.3e}; tol {rtol}", flush=True)
        check(floor <= rtol < fault, f"AllReduce() {label}: the tolerance "
              f"{rtol} does not lie between the floor {floor} and the "
              f"planted fault {fault}")
    try:
        t0 = time.perf_counter()
        run = strategy_run(torch, fa, cfg, device, "AllReduce()",
                           S.AllReduce(), batch, steps)
        ref, paths["strategy_allreduce"] = run.losses, run.launches
        del run
        print(f"  AllReduce(): losses {', '.join(f'{x:.6f}' for x in ref)}"
              f" ({time.perf_counter() - t0:.1f}s with set-up)", flush=True)
        bracket("eager", ref, False, STRATEGY_LOSS_RTOL)
        for key, label, builder, kinds in (
                ("ps", "AutoDist() = PS()", None, ("ar",)),
                ("ps_lb", "PSLoadBalancing()", S.PSLoadBalancing(), ("ar",)),
                ("partitioned_ps", "PartitionedPS()", S.PartitionedPS(),
                 ("ar",)),
                ("uneven_ps", "UnevenPartitionedPS()",
                 S.UnevenPartitionedPS(), ("ar",)),
                ("partitioned_ar", "PartitionedAR()", S.PartitionedAR(),
                 ("ar",)),
                ("random_axis_ar", "RandomAxisPartitionAR()",
                 S.RandomAxisPartitionAR(), ("ar",)),
                ("ps_stale2", "PS(staleness=2)", S.PS(staleness=2),
                 ("stale",))):
            run = strategy_run(torch, fa, cfg, device, label, builder, batch,
                               steps, kinds=kinds)
            if builder is None:
                check(all(n.WhichOneof("synchronizer") == "ps_synchronizer"
                          for n in run.runner.program.strategy.node_config),
                      "AutoDist() did not build PS()")
            held(label, run.losses, ref, STRATEGY_LOSS_RTOL)
            paths["strategy_" + key] = run.launches
            del run
        timings = {}
        for key, label, builder in (("allreduce", "AllReduce()",
                                     S.AllReduce()),
                                    ("parallax", "Parallax()",
                                     S.Parallax())):
            run = strategy_run(torch, fa, cfg, device, label + " aot",
                               builder, batch, graph_steps, aot=True)
            if label == "AllReduce()":
                graph_ref = run.losses
                bracket("aot", graph_ref, True, STRATEGY_GRAPH_RTOL)
            else:
                node = run.runner.program.strategy.node_by_name(
                    "embed/embedding")
                check(node.WhichOneof("synchronizer") == "ps_synchronizer",
                      "Parallax() did not send the embedding table to PS")
                held("Parallax() aot vs AllReduce() aot", run.losses,
                     graph_ref, STRATEGY_GRAPH_RTOL)
            paths[f"strategy_{key}_aot"] = run.launches
            med = float(np.median(run.times[4:]))
            line = (f"  {label} make_callable(aot=True): median host step "
                    f"(steps 5-{graph_steps}) {med:.3f} ms")
            if device == "cuda":
                dbatch = run.runner.remapper.shard_batch(batch)
                state = run.state

                def one_step(fn=run.step_fn):
                    nonlocal state
                    state, _ = fn(state, dbatch)
                wall, busy, rows = _busy_window(torch, one_step)
                timings[label] = (wall, busy)
                line += (f"; {BUSY_WINDOW} steps unprofiled {wall:.3f} "
                         f"ms/step (host-inclusive), device busy {busy:.3f} "
                         f"ms/step ({100 * busy / wall:.1f}%), "
                         f"{batch_size / wall * 1e3:.1f} samples/s")
                del state
            print(line + f" on {card}", flush=True)
            del run
        if timings:
            (w_ar, b_ar), (w_px, b_px) = (timings["AllReduce()"],
                                          timings["Parallax()"])
            print(f"  Parallax() / AllReduce() aot step: host-inclusive "
                  f"{w_px:.3f} / {w_ar:.3f} ms ({w_px / w_ar:.3f}x), device "
                  f"{b_px:.3f} / {b_ar:.3f} ms ({b_px / b_ar:.3f}x) on {card}",
                  flush=True)
    finally:
        autodist_mod._reset_default()
        if env is not None:
            os.environ["AUTODIST_STRATEGY"] = env
    return paths


def graph_serve_phase(torch, fa, card, cfg, device, requests=16, clients=4):
    """Phase 7, serving: phase 3's traffic on the port's Server, whose
    warmed buckets (4, 8) are CUDA graphs; returns the flash launches."""
    from autodist_tpu_torch import serve
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T

    seq = cfg.max_len
    print(f"phase 7: serve.Server on a {cfg.num_layers}-layer BERT at seq "
          f"{seq}, buckets (4, 8), one CUDA graph each", flush=True)
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)

    def apply_fn(p, batch):
        ids, seg = batch
        return T.encode(p, cfg, ids, segment_ids=seg).float()

    ids, seg, _, _ = bert.synthetic_batch(cfg, 8, seq, seed=0)
    rng = np.random.RandomState(1)  # phase 3's requests
    work = []
    for _ in range(requests):
        rows = int(rng.randint(1, 9))
        work.append((rng.randint(0, cfg.vocab, (rows, seq)).astype(np.int32),
                     rng.randint(0, 2, (rows, seq)).astype(np.int32)))
    answers, kept, latencies = ([None] * requests for _ in range(3))
    fa.flash_fwd.launches = 0  # main path: engine build + traffic
    srv = serve.Server(apply_fn, params, (ids, seg), buckets=(4, 8),
                       max_wait_ms=5, device=device)
    try:
        replica = srv.engine.replicas[0]
        graphs = bucket_graphs(srv.engine)
        warmups = len(graphs)
        if device == "cuda":
            check(all(g.captured for g in graphs.values()),
                  f"a warmed bucket has no CUDA graph: {graphs}")
        dispatched = []
        run_bucket = replica.run_bucket

        def recording(batch):
            host = run_bucket(batch)
            dispatched.append(([t.clone() for t in batch], host))
            return host
        replica.run_bucket = recording

        def client(c):
            for i in range(c, requests, clients):
                t = time.perf_counter()
                answers[i] = srv.submit(work[i]).result(timeout=300)
                latencies[i] = (time.perf_counter() - t) * 1e3
                kept[i] = answers[i].clone()

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), "clients hung")
        check(all(a is not None for a in answers), "a request got no answer")
        replica.run_bucket = run_bucket
        launches = fa.flash_fwd.launches
        replays = sum(g.replays for g in graphs.values())
        stats = srv.stats()
        dispatches = sum(r["dispatches"] for r in stats["replicas"])
        print(f"  {stats['completed']} requests in {dispatches} dispatches, "
              f"{replays} graph replays + {warmups} warm-ups; flash_fwd "
              f"launches {launches}", flush=True)
        check(stats["completed"] == requests, "requests lost")
        if device == "cuda":
            check(replays == dispatches == len(dispatched),
                  f"{dispatches} dispatches but {replays} graph replays")
        check(launches == cfg.num_layers * (dispatches + warmups),
              f"flash_fwd launched {launches} times, expected "
              f"{cfg.num_layers} x ({dispatches} replays + {warmups} "
              f"warm-ups)")
        with torch.inference_mode():
            for batch, host in dispatched:
                eager = replica._forward(batch).cpu()
                check(torch.equal(host, eager), "a bucket graph's answer is "
                      "not bitwise the eager forward of the same padded "
                      "batch")
        check(all(torch.equal(a, k) for a, k in zip(answers, kept)),
              "an answer changed after later dispatches")
        p50, p99 = np.percentile(latencies, 50), np.percentile(latencies, 99)
        print(f"  every dispatch's answer bitwise the eager forward of its "
              f"padded batch ({len(dispatched)} dispatches); every answer "
              f"unchanged after later dispatches; client p50 {p50:.3f} ms, "
              f"p99 {p99:.3f} ms (4 threads, rows 1-8) on {card}",
              flush=True)
        if device == "cuda":
            _dtoh_before_after(torch, card, srv, replica, (ids, seg))
    finally:
        srv.close()
    return launches


def _dtoh_before_after(torch, card, srv, replica, batch, n=6):
    """Wall and device time per full-bucket request, and its ``Memcpy
    DtoH``: the eager forward with a pageable ``.cpu()`` (before) against
    the Server's graph replay and pinned fetch (after)."""
    from torch.profiler import ProfilerActivity, profile
    placed = replica.remapper.shard_batch(batch)

    def before():
        with torch.inference_mode():
            replica._forward(placed).cpu()

    def after():
        srv.infer(batch, timeout=300)
    for label, fn in (("before: eager forward, pageable .cpu()", before),
                      ("after: Server, graph replay, pinned fetch", after)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        events = _device_events(prof)
        busy = sum(_device_us(e) for e in events) / 1e3 / n
        dtoh = sum(_device_us(e) for e in events
                   if "Memcpy DtoH" in e.key) / 1e3 / n
        kinds = sorted({e.key for e in events if "Memcpy DtoH" in e.key})
        print(f"  {label}, 8 x {batch[0].shape[1]}: wall {wall:.3f} "
              f"ms/request (profiled), device {busy:.3f} ms/request, "
              f"Memcpy DtoH {dtoh:.3f} ms/request ({', '.join(kinds)}) on "
              f"{card}", flush=True)


def short_kernel(mangled):
    """``flash_fwd_wgmma_kernel<d=64, f32 + bf16 out>`` from a mangled
    kernel name."""
    m = re.search(r"(flash_[a-z_]+_kernel)I(.*)EEv", mangled)
    if m is None:
        return mangled
    args = m.group(2)
    out = ("bf16 out, " if "bfloat16" in args or "Lb0E" in args
           else "f32 + bf16 out, " if "Lb1E" in args
           else "f32 out, " if args[:1] == "f" else "")
    dims = ",".join(re.findall(r"Li(\d+)E", args + "E"))
    return f"{m.group(1)}<{out}d={dims}>"


# Every TMA / wgmma instantiation, by library: {kernel: [(d, output)]}.
# The forward's template is <d, f32 out>, the backward's <output type, d>.
WGMMA_KERNELS = {
    "flash_fwd": {"flash_fwd_wgmma_kernel": [
        (d, out) for d in (64, 128) for out in ("bf16", "f32 + bf16")]},
    "flash_bwd": {
        "flash_bwd_dq_wgmma_kernel": [
            (d, out) for d in (64, 128) for out in ("f32", "bf16")],
        "flash_bwd_dkv_wgmma_kernel": [(64, "f32"), (64, "bf16")]},
}


def _wgmma_instance(name):
    """(kernel, d, output) of a TMA / wgmma kernel's mangled name, or None."""
    m = re.search(r"(flash_fwd_wgmma_kernel)ILi(\d+)ELb([01])E", name)
    if m:
        return (m.group(1), int(m.group(2)),
                "f32 + bf16" if m.group(3) == "1" else "bf16")
    m = re.search(r"(flash_bwd_d(?:q|kv)_wgmma_kernel)I(f|13__nv_bfloat16)"
                  r"Li(\d+)E", name)
    if m:
        return (m.group(1), int(m.group(3)),
                "f32" if m.group(2) == "f" else "bf16")
    return None


def sass_check(build):
    """Phase 1: every TMA / wgmma instantiation (the forward at d = 64 and
    128, bf16 and f32 + bf16 output; the backward's dq at d = 64 and 128 and
    dk/dv at d = 64, f32 and bf16 output) holds wgmma (HGMMA) and TMA load
    (UTMALDG) instructions in its SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    found = {}
    for lib in WGMMA_KERNELS:
        sass = subprocess.run([tool, "-sass", build.library_path(lib)[1]],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for body in sass.split("Function : ")[1:]:
            key = _wgmma_instance(body.split("\n", 1)[0])
            if key:
                found[key] = (body.count("HGMMA"), body.count("UTMALDG"))
    for kernels in WGMMA_KERNELS.values():
        for kernel, variants in kernels.items():
            for d, out in variants:
                hgmma, utmaldg = found.get((kernel, d, out), (0, 0))
                check(hgmma > 0 and utmaldg > 0,
                      f"{kernel}<d={d}, {out} out> has {hgmma} HGMMA and "
                      f"{utmaldg} UTMALDG instructions")
    print("  SASS (cuobjdump -sass): " + ", ".join(
        f"{k.replace('_wgmma_kernel', '')} d={d} {out} out: {h} HGMMA, "
        f"{u} UTMALDG"
        for (k, d, out), (h, u) in sorted(found.items())), flush=True)


# Phase 8's two-rank sub-phase: gloo ranks on the one card (NCCL refuses
# two ranks on one device; gloo takes CUDA tensors for all_reduce,
# reduce_scatter_tensor and all_gather_into_tensor, PERF.md) train BERT at
# BERT-base width and bert_tiny's depth under builders that split
# variables over the data axis, each rank on its half of the batch, held
# to one rank's AllReduce steps on the whole batch. SGD, not Adam: Adam's
# update does not see a gradient off by a constant factor (a missing / n
# in the reduce-scatter), SGD's does. Both the losses and the params'
# update are held: the update's relative L2 error (``update_error``) at
# GLOO_UPDATE_RTOL, which one rank's AllReduce at twice the learning rate
# (the gradient doubled, a missing / 2) must exceed. The model computes in
# bf16: each rank's weight gradients are rounded to bf16 over its half of
# the tokens before the f32 mean, where one rank rounds once over all of
# them, so the runs part by bf16 roundings. Read on an H100: losses within
# 5.7e-5, update errors 3.9e-3 to 4.8e-3; the doubled gradient 2.2e-2 and
# 0.94.
GLOO_WORLD, GLOO_LAYERS, GLOO_LR = 2, 2, 0.1
GLOO_UPDATE_RTOL = 5e-2
GLOO_BUILDERS = (("parallax", "Parallax", ("ar", "fsdp")),
                 ("partitioned_ps", "PartitionedPS", ("fsdp",)),
                 ("ps", "PS", ("zero1",)))


def _spawn_ranks(world, flag, spec, what, timeout=900):
    """``world`` processes of this script (``flag``: ``--gloo-train``,
    ``--sp-train``, ...) on the card, one gloo world over a free
    ``localhost`` port, each given ``spec`` (a JSON string); every rank's
    last printed line, parsed, in rank order. A rank that fails raises
    (``what`` names it), and no process outlives the call."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), str(world),
         str(port), spec], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    ranks = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            check(p.returncode == 0, f"{what} exited with {p.returncode}: "
                  f"{err[-3000:]}")
            ranks.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return ranks


def _gloo_cfg(cfg):
    small = copy.copy(cfg)
    small.num_layers = GLOO_LAYERS
    return small


# BERT-base's depth in phases 11 and 14 (full width, gloo ranks sharing the
# card), cut from 12 layers to keep the full run well inside its 1200 s
# limit (phase 14 took 81.5 s at 6 layers on a slower host).
GLOO_BERT_LAYERS = 3


def _gloo_bert(bert):
    cfg = bert.bert_base(max_len=512)
    cfg.num_layers = GLOO_BERT_LAYERS
    return cfg


def gloo_train_rank(rank, world, port, spec):
    """One rank of :func:`gloo_strategy_phase`: a gloo world over
    ``localhost`` on device 0 (``spec``: device, config, batch, steps and
    the one-rank reference's final params' file as JSON); for each builder
    of ``GLOO_BUILDERS`` ``steps`` eager SGD steps on this rank's rows.
    Prints {builder: losses, launches, mesh, the update's error against the
    reference, a digest of the logical params}."""
    import datetime
    import hashlib
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    fields = dict(spec["config"], dtype=getattr(torch, spec["dtype"]))
    cfg = T.TransformerConfig(**fields)
    batch = bert.synthetic_batch(cfg, spec["batch"], spec["seq"],
                                 spec["masked"], seed=0)
    ref = torch.load(spec["ref"], map_location=device)
    local = spec["batch"] // world
    mine = tuple(a[rank * local:(rank + 1) * local] for a in batch)
    out = {"rank": rank}
    for key, builder, kinds in GLOO_BUILDERS:
        run = strategy_run(torch, fa, cfg, device, f"rank {rank} {builder}()",
                           getattr(S, builder)(), mine, spec["steps"],
                           kinds=kinds, backend="gloo", optimizer="SGD",
                           lr=GLOO_LR)
        digest = hashlib.sha256()
        for name, t in sorted(run.params.items()):
            digest.update(t.detach().float().cpu().numpy().tobytes())
        err = update_error(torch, run.params, ref, run.init)
        out[key] = {"losses": run.losses, "launches": run.launches,
                    "mesh": dict(run.runner.program.mesh.shape),
                    "update_error": err,
                    "digest": digest.hexdigest()}
        try:  # a CUDA graph of gloo's collectives: refused, never eager
            run.runner.make_callable(mine, aot=True)
            out[key]["graph_refusal"] = None
        except RuntimeError as e:
            out[key]["graph_refusal"] = str(e)
        del run
    autodist_mod._reset_default()
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def gloo_strategy_phase(torch, fa, card, cfg, device, batch_size=32,
                        seq=128, num_masked=20, steps=STRATEGY_STEPS):
    """Phase 8, two ranks: ``GLOO_WORLD`` gloo ranks (processes of this
    script) on the one card train ``cfg`` at ``GLOO_LAYERS`` layers under
    ``GLOO_BUILDERS``, so the ZeRO-1 and split-parameter lowerings run
    beside the kernels on the device; each builder's losses and updates
    are held to one rank's ``AllReduce()`` run on the whole batch, the
    ranks' params must agree bitwise, and each rank's flash kernels launch
    once per layer and step. Returns {path: flash launches, summed over
    the ranks}."""
    import tempfile
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.ops import build
    small = _gloo_cfg(cfg)
    print(f"phase 8, {GLOO_WORLD} gloo ranks on one device: a "
          f"{small.num_layers}-layer, width {small.dim} BERT (batch "
          f"{batch_size} x {seq}, {batch_size // GLOO_WORLD} rows a rank, "
          f"SGD {GLOO_LR}), {steps} eager steps under " +
          ", ".join(f"{b}()" for _, b, _ in GLOO_BUILDERS), flush=True)
    batch = bert.synthetic_batch(small, batch_size, seq, num_masked, seed=0)
    try:
        ref = strategy_run(torch, fa, small, device, "one rank AllReduce()",
                           S.AllReduce(), batch, steps, optimizer="SGD",
                           lr=GLOO_LR)
        fault = strategy_run(torch, fa, small, device,
                             "one rank AllReduce() at twice the lr",
                             S.AllReduce(), batch, steps, optimizer="SGD",
                             lr=2 * GLOO_LR)
    finally:
        autodist_mod._reset_default()
    fault_err = update_error(torch, fault.params, ref.params, ref.init)
    fault_rel = max(abs(a - b) / abs(b)
                    for a, b in zip(fault.losses, ref.losses))
    print(f"  one rank AllReduce() at lr {2 * GLOO_LR} (the gradient "
          f"doubled) vs at {GLOO_LR}: max rel. loss diff {fault_rel:.3e}, "
          f"update error {fault_err:.3e} (tol {GLOO_UPDATE_RTOL})",
          flush=True)
    check(fault_err > GLOO_UPDATE_RTOL and fault_rel > STRATEGY_LOSS_RTOL,
          f"a doubled gradient reads within the tolerances: update error "
          f"{fault_err}, loss {fault_rel}")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    ref_path = os.path.join(tmp.name, "ref.pt")
    torch.save({n: t.detach().cpu() for n, t in ref.params.items()},
               ref_path)
    ref_losses = ref.losses
    del ref, fault
    fields = {k: v for k, v in vars(small).items() if k != "dtype"}
    spec = json.dumps({"device": device, "config": fields,
                       "dtype": str(small.dtype).split(".")[-1], "seq": seq,
                       "batch": batch_size, "masked": num_masked,
                       "steps": steps, "ref": ref_path})
    try:
        ranks = _spawn_ranks(GLOO_WORLD, "--gloo-train", spec, "a gloo rank",
                             timeout=600)
    finally:
        tmp.cleanup()
    paths = {}
    for key, builder, kinds in GLOO_BUILDERS:
        expr = f"{builder}()"
        got = [r[key] for r in ranks]
        losses = got[0]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        print(f"  {expr} on {GLOO_WORLD} ranks (mesh {got[0]['mesh']}, kinds "
              f"{'/'.join(kinds)}): losses "
              f"{', '.join(f'{x:.6f}' for x in losses)}; one rank "
              f"AllReduce() {', '.join(f'{x:.6f}' for x in ref_losses)}; max "
              f"rel. diff {rel:.3e} (tol {STRATEGY_LOSS_RTOL}); update error "
              f"{got[0]['update_error']:.3e} (tol {GLOO_UPDATE_RTOL}); params "
              f"equal on every rank: "
              f"{len({g['digest'] for g in got}) == 1}; flash launches per "
              f"rank {got[0]['launches']}", flush=True)
        check(all(g["losses"] == losses for g in got),
              f"{expr}: the ranks' losses differ: {got}")
        check(rel <= STRATEGY_LOSS_RTOL, f"{expr}: losses {losses} vs "
              f"one rank's {ref_losses}")
        check(got[0]["update_error"] <= GLOO_UPDATE_RTOL,
              f"{expr}: update error {got[0]['update_error']}")
        check(len({g["digest"] for g in got}) == 1,
              f"{expr}: the ranks' params differ")
        check(all(g["mesh"] == {"data": GLOO_WORLD} for g in got),
              f"{expr}: mesh {got[0]['mesh']}")
        if device == "cuda":
            refusal = got[0]["graph_refusal"]
            check(all(g["graph_refusal"] and "needs NCCL" in
                      g["graph_refusal"] and "gloo" in g["graph_refusal"]
                      for g in got), f"{expr}: make_callable(aot=True) over "
                  f"the gloo world did not refuse naming NCCL: {refusal}")
            print(f"    make_callable(aot=True) over the gloo group refuses "
                  f"(RuntimeError): ..."
                  f"{refusal[refusal.index('needs NCCL'):][:96]}...",
                  flush=True)
        paths[f"strategy_gloo{GLOO_WORLD}_{key}"] = {
            k: sum(g["launches"][k] for g in got) for k in got[0]["launches"]}
    return paths


# Phase 9: training that survives (checkpoint/ and resilience/).

def weighted_mlm_loss(cfg):
    """BERT's MLM loss times the mean of the batch's float masked-LM
    weights (BERT's pretraining input carries them; all 1 here, so the loss
    is bitwise the plain one): the float leaf ``AUTODIST_CHAOS=nan_at``
    poisons (it poisons only float leaves, and token ids are ints)."""
    from autodist_tpu_torch.models import bert
    base = bert.make_loss_fn(cfg)

    def loss_fn(params, batch):
        return base(params, tuple(batch[:4])) * batch[4].mean()
    return loss_fn


def weighted_batches(cfg, seeds, batch_size, seq, num_masked):
    """BERT's synthetic batches (one per seed) with MLM weights of 1."""
    from autodist_tpu_torch.models import bert
    return [bert.synthetic_batch(cfg, batch_size, seq, num_masked, seed=s) +
            (np.ones((batch_size, num_masked), np.float32),) for s in seeds]


def _bert_runner(torch, cfg, device, batch, params=None):
    """A fresh one-rank AllReduce() world training BERT (MLM weighted as
    above, Adam 1e-4) from ``params`` (default: the seeded init; a runner
    copies them and never writes them)."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    if params is None:
        params = bert.init(cfg, torch.Generator().manual_seed(0),
                           device=device)
    return ad.create_distributed_session(ad.capture(
        weighted_mlm_loss(cfg), params,
        functools.partial(torch.optim.Adam, lr=1e-4), example_batch=batch))


def _resnet_runner(torch, cfg, device, batch):
    """A fresh ResNet world (SGD 1e-3, AllReduce(chunk_size=128)) from the
    seeded init."""
    from autodist_tpu_torch.models import resnet
    ad = _zoo_world(torch, device)
    return ad.create_distributed_session(ad.capture(
        resnet.make_loss_fn(cfg),
        resnet.init(cfg, torch.Generator().manual_seed(0), device=device),
        functools.partial(torch.optim.SGD, lr=1e-3), example_batch=batch))


def _blocks(run, state, start, end, unroll):
    """Drive ``run(state, n)`` (a call that takes the state to step ``n``)
    one K-step block at a time from ``start`` to ``end``: (state, the
    per-step losses)."""
    losses = []
    for n in range(start + unroll, end + 1, unroll):
        state, metrics = run(state, n)
        losses += [float(x) for x in metrics["loss"].reshape(-1)]
    return state, losses


def _logical_named(runner, state):
    """The checkpoint form by name, on the host."""
    from autodist_tpu_torch.checkpoint.manifest import state_tree
    return {k: t.detach().cpu() for k, t in
            flatten_params(state_tree(runner.to_logical(state))).items()}


def _raw_named(path):
    from autodist_tpu_torch.checkpoint.saver import read_tree
    return flatten_params(read_tree(path))


def _same(torch, got, want):
    """Names whose tensors differ (dtype or bits)."""
    return sorted(set(got) ^ set(want)) + [
        n for n in want if n in got and (got[n].dtype != want[n].dtype or
                                         not torch.equal(got[n], want[n]))]


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _graph_of(runner):
    """The runner's one megastep graph (its phase-0 Graph)."""
    (step,) = runner._graphs.values()
    return step.graphs[0]


def _timed(torch, device, fn):
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _save_restore_rates(torch, card, label, runner, state, directory, device):
    """Host-inclusive save and restore (into the live state) of one
    checkpoint: prints bytes, ms and GB/s; returns the state."""
    from autodist_tpu_torch.checkpoint import Saver
    path = os.path.join(directory, f"{label}-timed")
    _, save_ms = _timed(torch, device, lambda: Saver(runner).save(state, path))
    nbytes = os.path.getsize(os.path.join(path, "arrays.bin"))
    state, restore_ms = _timed(
        torch, device, lambda: Saver(runner).restore(path, into=state))
    print(f"  {label} checkpoint: {nbytes} bytes ({nbytes / 1e9:.3f} GB); "
          f"save {save_ms:.1f} ms ({nbytes / save_ms / 1e6:.2f} GB/s), "
          f"restore into the live state {restore_ms:.1f} ms "
          f"({nbytes / restore_ms / 1e6:.2f} GB/s), host-inclusive, on "
          f"{card}", flush=True)
    shutil.rmtree(path)
    return state


def resilience_guard_run(torch, fa, card, cfg, device, batch, directory,
                         init):
    """(a) BERT's graph step under ``CheckpointManager.run`` with a
    ``StepGuard`` and ``AUTODIST_CHAOS=nan_at``: exactly one rollback
    (into the graph's own tensors, no new capture), no retained step with
    non-finite params, finite falling losses, every leaf of the newest
    step (Adam's ``step`` included) bitwise the live state's. Returns
    (runner, state, flash launches)."""
    from autodist_tpu_torch import resilience
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.resilience import StepGuard, chaos
    runner = _bert_runner(torch, cfg, device, batch, init)
    dbatch = runner.remapper.shard_batch(batch)
    mgr = CheckpointManager(runner, directory,
                            save_interval_steps=RESIL_INTERVAL, max_to_keep=3)
    guard = StepGuard(check_every=RESIL_CHECK, max_strikes=3)
    resilience.clear_events()
    chaos.reset()
    os.environ["AUTODIST_CHAOS"] = f"nan_at={RESIL_NAN_AT}"
    _flash_counts(fa, reset=True)  # this path's run
    try:
        data = iter(lambda: dbatch, None)
        state, first = mgr.run(mgr.restore_or_init(), data, RESIL_UNROLL,
                               step_guard=guard, unroll=RESIL_UNROLL)
        graph = _graph_of(runner)
        state, last = mgr.run(state, data, RESIL_STEPS, step_guard=guard,
                              unroll=RESIL_UNROLL)
    finally:
        del os.environ["AUTODIST_CHAOS"]
        chaos.reset()
    launches = _flash_counts(fa)
    events = [(k, d) for _, k, d in resilience.events()]
    first, last = ([float(x) for x in m["loss"]] for m in (first, last))
    print(f"  (a) {RESIL_STEPS} steps, {RESIL_UNROLL} a CUDA graph, save "
          f"every {RESIL_INTERVAL}, guard every {RESIL_CHECK}, nan_at="
          f"{RESIL_NAN_AT}: rollbacks {guard.rollbacks}, events {events}; "
          f"retained steps {mgr.all_steps()}; losses first block "
          f"{first}, last {last}; graph captured once, replays "
          f"{graph.replays}; flash launches {launches}", flush=True)
    dispatched = RESIL_STEPS // RESIL_UNROLL + 1  # + the poisoned block
    check(guard.rollbacks == 1 and ("chaos:nan", f"poisoned batch at step "
          f"{RESIL_NAN_AT}") in events,
          f"(a): {guard.rollbacks} rollbacks, events {events}")
    seen = -(-RESIL_NAN_AT // RESIL_UNROLL) * RESIL_UNROLL  # block's end
    check(("rollback", f"divergence at step {seen}: restored step "
           f"{(seen - 1) // RESIL_INTERVAL * RESIL_INTERVAL} (strike 1/3)")
          in events, f"(a): rollback events {events}")
    check(int(state.step) == RESIL_STEPS, f"(a) ended at {int(state.step)}")
    check(all(np.isfinite(first + last)) and max(last) < min(first),
          f"(a): losses {first} ... {last}")
    check(_graph_of(runner) is graph and len(runner._graphs) == 1 and
          (device != "cuda" or graph.replays == dispatched - 1),
          f"(a): the rollback recaptured: {runner._graphs}")
    for name, n in launches.items():
        check(n == cfg.num_layers * dispatched * RESIL_UNROLL,
              f"(a): {name} launched {n} times, expected {cfg.num_layers} "
              f"x {dispatched * RESIL_UNROLL}")
    steps = mgr.all_steps()
    check(steps == list(range(RESIL_STEPS - 2 * RESIL_INTERVAL,
                              RESIL_STEPS + 1, RESIL_INTERVAL)),
          f"(a): retained steps {steps}")
    for step in steps:
        raw = _raw_named(os.path.join(directory, str(step)))
        bad = [n for n, t in raw.items() if n.startswith("params/")
               and not torch.isfinite(t).all()]
        check(not bad, f"(a): retained step {step} holds non-finite {bad}")
    diff = _same(torch, _raw_named(os.path.join(directory, str(steps[-1]))),
                 _logical_named(runner, state))
    check(not diff, f"(a): the saved step {steps[-1]} differs from the live "
          f"state at {diff[:5]}")
    adam = next(iter(state.opt_state.state.values()))["step"]
    print(f"  (a) step {steps[-1]}: every leaf bitwise the live state's "
          f"({len(raw)} leaves; Adam's step {float(adam)} on "
          f"{adam.device})", flush=True)
    if device == "cuda":
        check(adam.device.type == "cuda", f"(a): Adam's step on {adam.device}")
    return runner, state, launches


def resilience_resume(torch, fa, card, label, make_runner, batches,
                      directory, device, fault=None):
    """(a) / (b): an uninterrupted run of ``RESIL_RESUME_STEPS`` graph steps
    (K a graph) under ``CheckpointManager.run`` saving every
    ``RESIL_RESUME_FROM``, the same again (the floor), then (d) its newest
    step truncated, a fresh Runner's ``restore_or_init`` falling back to
    step ``RESIL_RESUME_FROM`` (every leaf bitwise the saved one) and
    resuming to the end, and with ``fault`` (a function of the restored
    state) the planted fault from the same step. Returns {"floor",
    "resume", "fault": max rel. loss differences over the resumed steps,
    "launches": the resumed run's flash launches, "params": bitwise or
    not}."""
    from autodist_tpu_torch import resilience
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.resilience import chaos
    n, k, at = RESIL_RESUME_STEPS, RESIL_UNROLL, RESIL_RESUME_FROM
    runner = make_runner()
    dbatches = [runner.remapper.shard_batch(b) for b in batches]

    def stream(start):
        return iter(dbatches[i % len(dbatches)] for i in range(start, n))

    mgr = CheckpointManager(runner, directory, save_interval_steps=at,
                            max_to_keep=3)
    data = stream(0)
    state, ref = _blocks(lambda s, m: mgr.run(s, data, m, unroll=k),
                         mgr.restore_or_init(), 0, n, k)
    ref_params = flatten_params(runner.logical_params(state))
    ref_params = {name: t.detach().clone() for name, t in ref_params.items()}
    data = stream(0)
    state, again = _blocks(lambda s, m: runner.run(s, data, k, unroll=k),
                           runner.create_state(), 0, n, k)
    floor = _rel(again[at:], ref[at:])
    # Update errors over the resumed steps: ||p - p_ref|| / ||p_ref - p_at||.
    at_params = {name[len("params/"):]: t for name, t in _raw_named(
        os.path.join(directory, str(at))).items() if name.startswith(
            "params/")}

    def update(params):
        return update_error(torch, {name: t.detach().cpu() for name, t in
                                    flatten_params(params).items()},
                            {name: t.cpu() for name, t in ref_params.items()},
                            at_params)
    floor_update = update(runner.logical_params(state))
    del state
    check(mgr.all_steps() == [k, at, n], f"{label}: steps {mgr.all_steps()}")
    check(chaos.truncate_checkpoint(directory) == n, f"{label}: truncation")
    runner = make_runner()  # a fresh Runner in a fresh world
    resilience.clear_events()
    mgr = CheckpointManager(runner, directory, save_interval_steps=at,
                            max_to_keep=3)
    state = mgr.restore_or_init()
    fell = [d for _, kind, d in resilience.events() if kind == "ckpt-fallback"]
    check(int(state.step) == at and len(fell) == 1,
          f"{label}: restore_or_init gave step {int(state.step)}, fallbacks "
          f"{fell}")
    diff = _same(torch, _logical_named(runner, state),
                 _raw_named(os.path.join(directory, str(at))))
    check(not diff, f"{label}: restored leaves differ from step {at}'s: "
          f"{diff[:5]}")
    dbatches = [runner.remapper.shard_batch(b) for b in batches]
    _flash_counts(fa, reset=True)  # the resumed run
    data = stream(at)
    state, resumed = _blocks(lambda s, m: mgr.run(s, data, m, unroll=k),
                             state, at, n, k)
    launches = _flash_counts(fa)
    got = flatten_params(runner.logical_params(state))
    params_equal = all(torch.equal(got[name], t)
                       for name, t in ref_params.items())
    out = {"floor": floor, "resume": _rel(resumed, ref[at:]),
           "launches": launches, "params": params_equal,
           "floor_update": floor_update,
           "resume_update": update(runner.logical_params(state))}
    print(f"  {label}: uninterrupted losses {ref[0]:.6f} ... {ref[-1]:.6f}; "
          f"(d) newest step {n} truncated -> restore_or_init fell back to "
          f"step {at} (every leaf bitwise); resumed steps {at + 1}-{n} vs "
          f"the uninterrupted run: max rel. loss diff {out['resume']:.3e} "
          f"(bitwise: {resumed == ref[at:]}), final params bitwise: "
          f"{params_equal}; floor (the same program again) {floor:.3e}; "
          f"update error over steps {at + 1}-{n}: resumed "
          f"{out['resume_update']:.3e}, floor {floor_update:.3e}",
          flush=True)
    if fault is not None:
        state = mgr.restore_or_init(into=state)
        graph = _graph_of(runner)
        fault(state)
        data = stream(at)
        state, faulty = _blocks(lambda s, m: mgr.run(s, data, m, unroll=k),
                                state, at, n, k)
        out["fault"] = _rel(faulty, ref[at:])
        out["fault_update"] = update(runner.logical_params(state))
        check(_graph_of(runner) is graph, f"{label}: the restore into the "
              f"live state recaptured")
        print(f"  {label}: planted fault (resume with Adam's moments zeroed) "
              f"max rel. loss diff {out['fault']:.3e}, update error "
              f"{out['fault_update']:.3e}", flush=True)
    del state
    return out


def preempt_train_child(directory, spec):
    """(c)'s child: BERT's eager step under ``CheckpointManager.run(
    preemption=True)``. Prints {"batch": n} as it hands out batch n, and
    at batch ``PREEMPT_AT`` waits for the SIGTERM; the emergency save and
    ``Preempted`` (exit code 128 + 15) follow. Prints what it saved."""
    import torch
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.resilience import Preempted
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
        torch, spec["dtype"])))
    (batch,) = weighted_batches(cfg, [0], spec["batch"], spec["seq"],
                                spec["masked"])
    runner = _bert_runner(torch, cfg, device, batch)
    mgr = CheckpointManager(runner, directory, save_interval_steps=100)
    dbatch = runner.remapper.shard_batch(batch)

    def batches():
        n = 0
        while True:
            n += 1
            print(json.dumps({"batch": n}), flush=True)
            if n == PREEMPT_AT:  # the loop's handler is installed
                handler = signal.getsignal(signal.SIGTERM).__self__
                deadline = time.monotonic() + 300
                while not handler.preempted and time.monotonic() < deadline:
                    time.sleep(0.01)
            yield dbatch

    _flash_counts(fa, reset=True)
    try:
        mgr.run(mgr.restore_or_init(), batches(), 10 ** 6, preemption=True)
    except Preempted as e:
        print(json.dumps({"saved_step": e.saved_step, "code": e.code,
                          "steps": mgr.all_steps(),
                          "launches": _flash_counts(fa)}), flush=True)
        raise
    return 1  # not preempted


def preempt_start(cfg, device, directory, batch_size, seq, num_masked):
    """(c), first half: start the child (this script, ``--preempt-train``)
    and a thread that sends it SIGTERM when it asks for batch
    ``PREEMPT_AT``. Returns (child, thread, log path, start time)."""
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = json.dumps({"device": device, "config": fields,
                       "dtype": str(cfg.dtype).split(".")[-1], "seq": seq,
                       "batch": batch_size, "masked": num_masked})
    log = directory + "-child.log"
    with open(log, "w") as err:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--preempt-train",
             directory, spec], stdout=subprocess.PIPE, stderr=err, text=True)
    lines = []

    def watch():
        for line in child.stdout:
            lines.append(line)
            if line.startswith("{") and \
                    json.loads(line).get("batch") == PREEMPT_AT:
                child.send_signal(signal.SIGTERM)
        child.wait()
    thread = threading.Thread(target=watch, daemon=True)
    thread.start()
    return types.SimpleNamespace(child=child, thread=thread, log=log,
                                 lines=lines, t0=time.perf_counter(),
                                 directory=directory)


def preempt_finish(torch, fa, cfg, device, batch, job, init):
    """(c), second half: the child exited with 128 + 15 after saving step
    ``PREEMPT_AT``; this process resumes from that step and takes 4 more.
    Returns the flash launches (child + resume)."""
    from autodist_tpu_torch.checkpoint import CheckpointManager
    job.thread.join(timeout=600)
    if job.child.poll() is None:
        job.child.kill()
        job.child.wait()
    child_s = time.perf_counter() - job.t0
    with open(job.log) as f:
        tail = f.read()[-3000:]
    check(job.child.returncode == 128 + signal.SIGTERM,
          f"(c): the child exited with {job.child.returncode}: {tail}")
    report = json.loads(job.lines[-1])
    check(report.get("saved_step") == PREEMPT_AT and
          report["code"] == 128 + signal.SIGTERM and
          report["steps"] == [1, PREEMPT_AT],
          f"(c): the child reported {report}")
    runner = _bert_runner(torch, cfg, device, batch, init)
    mgr = CheckpointManager(runner, job.directory, save_interval_steps=100)
    _flash_counts(fa, reset=True)  # the resume
    state = mgr.restore_or_init()
    check(int(state.step) == PREEMPT_AT, f"(c): resumed at {int(state.step)}")
    dbatch = runner.remapper.shard_batch(batch)
    losses = []
    for n in range(PREEMPT_AT + 1, PREEMPT_AT + 5):
        state, metrics = mgr.run(state, iter([dbatch]), n)
        losses.append(float(metrics["loss"]))
    launches = _flash_counts(fa)
    check(int(state.step) == PREEMPT_AT + 4 and all(np.isfinite(losses)),
          f"(c): resumed to {int(state.step)}, losses {losses}")
    total = {k: report["launches"][k] + launches[k] for k in launches}
    for name, n in total.items():
        check(n == cfg.num_layers * (PREEMPT_AT + 4),
              f"(c): {name} launched {n} times, expected {cfg.num_layers} x "
              f"{PREEMPT_AT + 4}")
    print(f"  (c) child (BERT eager, preemption=True) got SIGTERM at batch "
          f"{PREEMPT_AT}: exit code {job.child.returncode}, emergency step "
          f"{report['saved_step']} (retained {report['steps']}), "
          f"{child_s:.1f} s from its start (beside the other parts); "
          f"resumed here from step {PREEMPT_AT}: losses "
          f"{', '.join(f'{x:.6f}' for x in losses)}; flash launches (child "
          f"+ resume) {total}", flush=True)
    return total


def guard_cost(torch, card, runner, batches, device):
    """The guard's cost on the graph step: ``Runner.run(unroll=K)`` over
    ``GUARD_COST_STEPS`` steps with no guard, a ``StepGuard`` at
    ``check_every`` 1 (every block: a flag read and a refresh of the
    device snapshot) and at 10, and no guard again; host-inclusive ms per
    step. Each guard is warmed first (its snapshot allocated and copied
    by one ``mark_good``, timed on its own), so a reading is the steady
    per-check cost."""
    from autodist_tpu_torch.resilience import StepGuard
    state = runner.create_state()
    dbatches = [runner.remapper.shard_batch(b) for b in batches]

    def run(guard):
        nonlocal state
        data = iter(dbatches[i % len(dbatches)]
                    for i in range(GUARD_COST_STEPS))
        (state, _), ms = _timed(torch, device, lambda: runner.run(
            state, data, GUARD_COST_STEPS, step_guard=guard,
            unroll=RESIL_UNROLL))
        return ms / GUARD_COST_STEPS

    def guarded(check_every):
        guard = StepGuard(check_every)
        _, alloc_ms = _timed(torch, device, lambda: guard.mark_good(0, state))
        alloc.append(alloc_ms)
        return run(guard)
    alloc = []
    run(None)  # capture
    rows = [("none", run(None)), ("check_every=1", guarded(1)),
            ("check_every=10", guarded(10)), ("none", run(None))]
    nbytes = sum(t.numel() * t.element_size()
                 for t in _state_tensors(torch, state))
    print(f"  guard cost, BERT graph step (unroll={RESIL_UNROLL}), "
          f"{GUARD_COST_STEPS} steps a reading, host-inclusive ms/step: " +
          ", ".join(f"{k} {v:.3f}" for k, v in rows) +
          f"; the snapshot holds {nbytes} bytes ({nbytes / 1e9:.3f} GB) on "
          f"the device, its allocation and first copy took " +
          " / ".join(f"{ms:.3f}" for ms in alloc) + f" ms; on {card}",
          flush=True)
    return rows


def save_stall(torch, card, runner, batches, device, directory):
    """(f) The graph step around an asynchronous save. A K-step graph's
    median over ``SAVE_STALL_STEPS``; then twice (the first save allocates
    the pinned staging buffer, the second reuses it) the host-inclusive
    time of ``CheckpointManager.save`` (it returns once the copy into
    pinned memory is queued) followed by one graph, which waits on the
    device for that copy: its excess over the median is the stall. The
    graphs after it run while the writer thread writes, and
    ``wait_until_finished`` is timed at the end; beside them a synchronous
    ``Saver.save`` of the same state. Each saved step must be bitwise the
    state as it was at its save, though the state took steps during the
    write."""
    from autodist_tpu_torch.checkpoint import CheckpointManager, Saver
    state = runner.create_state()
    data = itertools.cycle([runner.remapper.shard_batch(b) for b in batches])
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def graph():
        nonlocal state
        state, _ = runner.megastep(state, runner._next_block(
            data, RESIL_UNROLL))

    def timed_graph():
        return _timed(torch, device, graph)[1]
    for _ in range(2):
        graph()  # capture, then one replay
    median = float(np.median([timed_graph()
                              for _ in range(SAVE_STALL_STEPS)]))
    mgr = CheckpointManager(runner, os.path.join(directory, "stall"),
                            save_interval_steps=None)
    rows = []
    for _ in range(2):
        want = {k: t.clone() for k, t in
                _logical_named(runner, state).items()}
        step = int(state.step)
        sync()
        t0 = time.perf_counter()
        mgr.save(step, state, force=True)
        t1 = time.perf_counter()
        graph()
        sync()
        t2 = time.perf_counter()
        after = [timed_graph() for _ in range(SAVE_STALL_STEPS)]
        _, wait_ms = _timed(torch, device, mgr.wait_until_finished)
        diff = _same(torch, _raw_named(os.path.join(directory, "stall",
                                                    str(step))), want)
        check(not diff, f"(f): the async save of step {step} differs from "
              f"the state at the save in {diff[:5]}")
        rows.append({"save_ms": (t1 - t0) * 1e3,
                     "stall_ms": (t2 - t0) * 1e3 - median,
                     "after_ms": after, "wait_ms": wait_ms})
    path = os.path.join(directory, "stall-sync")
    _, sync_ms = _timed(torch, device, lambda: Saver(runner).save(state,
                                                                  path))
    print(f"  (f) save stall, BERT graph step (unroll={RESIL_UNROLL}), "
          f"host-inclusive ms: a graph {median:.3f} (median of "
          f"{SAVE_STALL_STEPS}); " + "; ".join(
              f"save {i + 1}"
              f"{' (allocates the pinned buffer)' if i == 0 else ''}: "
              f"CheckpointManager.save returned in {r['save_ms']:.3f}, "
              f"with the graph after it {r['stall_ms']:.3f} over the median"
              f" (the stall), the next graphs "
              f"{', '.join(f'{x:.3f}' for x in r['after_ms'])}, then "
              f"wait_until_finished {r['wait_ms']:.3f}"
              for i, r in enumerate(rows)) +
          f"; a synchronous Saver.save {sync_ms:.3f}; each step read back "
          f"bitwise the state at its save; on {card}", flush=True)
    check(device != "cuda" or max(r["stall_ms"] for r in rows) < sync_ms,
          f"(f): a save stalls the step {rows}, a synchronous save takes "
          f"{sync_ms} ms")
    shutil.rmtree(os.path.join(directory, "stall"))
    shutil.rmtree(path)
    return {"graph_ms": median, "saves": rows, "sync_save_ms": sync_ms}


def resilience_serve(torch, fa, card, cfg, device, params, want, request,
                     label="(e)"):
    """(e): params restored from a checkpoint serve through
    ``serve.Server`` (bucket 8 x seq): the answer bitwise the eager
    forward of the trained params (``want``). Returns the flash launches
    (warm-up + replays)."""
    from autodist_tpu_torch import serve
    from autodist_tpu_torch.models import transformer as T

    def apply_fn(p, batch):
        ids, seg = batch
        return T.encode(p, cfg, ids, segment_ids=seg).float()
    rows = request[0].shape[0]
    _flash_counts(fa, reset=True)  # the serving path
    with serve.Server(apply_fn, params, request, buckets=(rows,),
                      max_wait_ms=1, device=device) as srv:
        got = srv.infer(request, timeout=300)
        graphs = bucket_graphs(srv.engine)
        dispatches = sum(r["dispatches"] for r in srv.stats()["replicas"])
    launches = _flash_counts(fa)["flash_fwd"]
    check(torch.equal(got, want), f"{label}: the served answer is not bitwise "
          f"the trained params' eager forward (max diff "
          f"{(got - want).abs().max().item()})")
    replays = sum(g.replays for g in graphs.values())
    check(launches == cfg.num_layers * (len(graphs) + dispatches) and
          (device != "cuda" or replays == dispatches),
          f"{label}: flash_fwd launched {launches} times, {replays} replays "
          f"in {dispatches} dispatches")
    print(f"  {label} restored params served (bucket {rows} x "
          f"{request[0].shape[1]}): the answer bitwise the trained params' "
          f"eager forward; flash_fwd launches {launches} ({len(graphs)} "
          f"warm-up + {dispatches} dispatches, {replays} graph replays)",
          flush=True)
    return launches


def resilience_phase(torch, fa, card, cfg, resnet_cfg, device, batch_size=32,
                     seq=128, num_masked=20, image=224, resnet_batch=64,
                     serve_rows=8):
    """Phase 9: checkpoint/ and resilience/ on BERT (a, c, d, e: graph and
    eager steps through the flash kernels) and ResNet (b). The timed parts
    run first; then the preempted child (c) runs beside (e), the resumes
    and (b). Returns {path: flash launches}."""
    import tempfile
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import bert, resnet
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    print(f"phase 9: training that survives; a {cfg.num_layers}-layer, width "
          f"{cfg.dim} BERT (MLM, batch {batch_size} x {seq}, Adam 1e-4) and "
          f"ResNet (stages {resnet_cfg.stage_sizes}, batch {resnet_batch} x "
          f"{image}^2, SGD 1e-3)", flush=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    guard_dir = os.path.join(tmp.name, "guard")
    paths, job = {}, None
    try:
        init = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
        (batch,) = weighted_batches(cfg, [0], batch_size, seq, num_masked)
        batches = weighted_batches(cfg, range(RESIL_RESUME_STEPS), batch_size,
                                   seq, num_masked)
        runner, state, paths["resilience_bert_guard"] = resilience_guard_run(
            torch, fa, card, cfg, device, batch, guard_dir, init)
        state = _save_restore_rates(torch, card, "BERT", runner, state,
                                    tmp.name, device)
        # (e)'s reference: the trained params' eager forward, on a request
        # of a full bucket at seq = the model's max_len.
        ids, seg, _, _ = bert.synthetic_batch(cfg, serve_rows, cfg.max_len,
                                              seed=1)
        with torch.inference_mode():
            want = T.encode(runner.logical_params(state), cfg,
                            torch.as_tensor(ids, device=device),
                            segment_ids=torch.as_tensor(
                                seg, device=device)).float().cpu()
        del state
        guard_cost(torch, card, runner, batches, device)
        save_stall(torch, card, runner, batches, device, tmp.name)
        runner = None
        rbatches = [resnet.synthetic_batch(resnet_batch, image,
                                           resnet_cfg.num_classes, seed=s)
                    for s in range(4)]
        runner = _resnet_runner(torch, resnet_cfg, device, rbatches[0])
        _save_restore_rates(torch, card, "ResNet", runner,
                            runner.create_state(), tmp.name, device)
        runner = None
        autodist_mod._reset_default()

        job = preempt_start(cfg, device, os.path.join(tmp.name, "preempt"),
                            batch_size, seq, num_masked)
        params = CheckpointManager(None, guard_dir).restore_params()
        paths["resilience_serve"] = {
            "flash_fwd": resilience_serve(torch, fa, card, cfg, device,
                                          params, want, (ids, seg)),
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        del params
        shutil.rmtree(guard_dir)

        def zero_moments(state):
            with torch.no_grad():
                for st in state.opt_state.state.values():
                    st["exp_avg"].zero_()
                    st["exp_avg_sq"].zero_()
        got = resilience_resume(
            torch, fa, card, "(a) BERT resume",
            lambda: _bert_runner(torch, cfg, device, batches[0], init),
            batches, os.path.join(tmp.name, "bert"), device,
            fault=zero_moments)
        for what, tol, key in (("losses", RESUME_RTOL, ""),
                               ("update", RESUME_UPDATE_RTOL, "_update")):
            floor, fault, resumed = (got[k + key] for k in
                                     ("floor", "fault", "resume"))
            print(f"  (a) BERT resume, {what}: floor {floor:.3e} < "
                  f"tolerance {tol} < planted fault {fault:.3e}; resumed "
                  f"{resumed:.3e}", flush=True)
            check(floor < tol < fault, f"(a): the {what} tolerance {tol} "
                  f"does not lie between the floor {floor} and the fault "
                  f"{fault}")
            check(resumed <= tol, f"(a): the resumed {what} are {resumed} "
                  f"off the uninterrupted run's")
        for name, n in got["launches"].items():
            check(n == cfg.num_layers * (RESIL_RESUME_STEPS -
                                         RESIL_RESUME_FROM),
                  f"(a) resume: {name} launched {n} times")
        paths["resilience_bert_resume"] = got["launches"]
        shutil.rmtree(os.path.join(tmp.name, "bert"))

        got = resilience_resume(
            torch, fa, card, "(b) ResNet resume",
            lambda: _resnet_runner(torch, resnet_cfg, device, rbatches[0]),
            rbatches, os.path.join(tmp.name, "resnet"), device)
        check(not any(got["launches"].values()), f"(b): flash launches "
              f"{got['launches']} in a model without attention")
        check(got["floor"] == got["resume"] == 0 and got["params"],
              f"(b): the resumed run is not bitwise the uninterrupted one "
              f"({got})")
        paths["resilience_resnet_resume"] = got["launches"]
        shutil.rmtree(os.path.join(tmp.name, "resnet"))

        paths["resilience_bert_preempted"] = preempt_finish(
            torch, fa, cfg, device, batch, job, init)
    finally:
        if job is not None and job.child.poll() is None:
            job.child.kill()
            job.child.wait()
        autodist_mod._reset_default()
        tmp.cleanup()
    return paths


# Phase 10: sequence parallelism.

def _ring_counts(fa, reset=False):
    """Launch counts of the flash kernels and of the hop wrappers."""
    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
               fa.block_attn_fwd, fa.block_attn_bwd)
    if reset:
        for k in kernels:
            k.launches = 0
    return {k.__name__: k.launches for k in kernels}


def ring_emulated(torch, fa, q, k, v, do, hops, drop=None):
    """The ring of ``hops`` ranks over q/k/v/do (b, h, s, d), in one
    process: rank r holds chunk r; at hop t it attends to chunk r - t
    (``block_attn_fwd`` at the global offsets, merged by
    ``combine_blocks``), and the backward accumulates each chunk's dk / dv
    in the order the ring carries it (hop by hop). ``drop`` = (r, t) skips
    that hop of rank r, forward and backward (the planted fault). Returns
    (o, dq, dk, dv) in q's dtype."""
    s = q.shape[2] // hops
    qs, ks, vs, dos = (x.split(s, dim=2) for x in (q, k, v, do))
    o = [torch.zeros(qs[0].shape, dtype=torch.float32, device=q.device)
         for _ in range(hops)]
    lse = [torch.full(qs[0].shape[:3] + (1,), -1e30, device=q.device)
           for _ in range(hops)]
    for t in range(hops):
        for r in range(hops):
            j = (r - t) % hops
            if (r, t) != drop:
                ob, lb = fa.block_attn_fwd(qs[r], ks[j], vs[j], True, r * s,
                                           j * s)
                o[r], lse[r] = fa.combine_blocks(o[r], lse[r], ob, lb)
    delta = [(d * x).sum(-1, keepdim=True) for d, x in zip(dos, o)]
    dq = [torch.zeros_like(x) for x in o]
    dk = [torch.zeros_like(x) for x in o]
    dv = [torch.zeros_like(x) for x in o]
    for t in range(hops):
        for r in range(hops):
            j = (r - t) % hops
            if (r, t) != drop:
                g = fa.block_attn_bwd(qs[r], ks[j], vs[j], dos[r], lse[r],
                                      delta[r], True, r * s, j * s)
                dq[r] += g[0]
                dk[j] += g[1]
                dv[j] += g[2]
    return [torch.cat(x, dim=2).to(q.dtype) for x in (o, dq, dk, dv)]


def ring_kernel_phase(torch, fa):
    """Phase 10 (a): the hop functions on the card at lm1b's width, each
    hop against its plain version, the emulated ring against one
    whole-sequence flash_attention call (forward and backward), between
    its reading and a dropped hop; then the hop kernels timed at the
    diagonal hop and at a fully visible one. Returns the two records."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    bf16, f32 = torch.bfloat16, torch.float32
    b, h, seq, d = SP_SHAPE
    s = seq // SP_HOPS
    q, k, v, do = (torch.randn(SP_SHAPE, generator=gen, device=dev,
                               dtype=bf16) for _ in range(4))
    print(f"phase 10 (a): ring attention's hops, b{b} h{h} d{d} bf16 causal,"
          f" a global sequence of {seq} as {SP_HOPS} hops of {s}", flush=True)
    errs = {"block_attn_fwd": 0.0, "block_attn_bwd": 0.0}
    qs, ks, vs, dos = (x.split(s, dim=2) for x in (q, k, v, do))
    # Every (rank, chunk) block, with the global lse and delta the ring
    # would hold: the whole sequence's, from one forward.
    o_all, lse_all = fa.flash_fwd(q, k, v, True, out_dtype=f32)
    delta_all = (do * o_all).sum(-1, keepdim=True)
    lses = [x.contiguous() for x in lse_all.split(s, dim=2)]
    deltas = [x.contiguous() for x in delta_all.split(s, dim=2)]
    for r in range(SP_HOPS):
        for j in range(SP_HOPS):
            masked = j > r
            args = (qs[r], ks[j], vs[j], True, r * s, j * s)
            o_b, lse_b = fa.block_attn_fwd(*args)
            o_p, lse_p = fa.flash_fwd_reference(*args, out_dtype=f32)
            err_o = (o_b - o_p).abs().max().item()
            err_l = (lse_b - lse_p).abs().max().item()
            check(bool(torch.isfinite(o_b).all()) and err_o <= O_F32_ATOL
                  and err_l <= LSE_ATOL, f"(a) block ({r}, {j}): o off by "
                  f"{err_o}, lse by {err_l}")
            bargs = (qs[r], ks[j], vs[j], dos[r], lses[r], deltas[r], True,
                     r * s, j * s)
            got = fa.block_attn_bwd(*bargs)
            ref = fa.flash_bwd_reference(*bargs)
            line = []
            for label, g, want in zip(("dq", "dk", "dv"), got, ref):
                tol = BWD_REL_DV_BF16 if label == "dv" else BWD_REL_DQDK_BF16
                err = (g - want).abs().max().item()
                scale = want.abs().max().item()
                check(bool(torch.isfinite(g).all()) and
                      err <= tol * max(scale, 1e-30), f"(a) block ({r}, "
                      f"{j}): {label} off by {err} (max {scale})")
                line.append(f"{label} {err:.2e}")
                errs["block_attn_bwd"] = max(errs["block_attn_bwd"], err)
            errs["block_attn_fwd"] = max(errs["block_attn_fwd"], err_o)
            if masked:
                check(not o_b.any() and bool((lse_b == -1e30).all()) and
                      not any(g.any() for g in got), f"(a) the wholly "
                      f"masked block ({r}, {j}) is not o = 0, lse = -1e30, "
                      f"gradients 0")
            print(f"  block (q chunk {r}, k chunk {j})"
                  f"{' wholly masked' if masked else ''}: max|kernel-plain| "
                  f"o {err_o:.2e}, lse {err_l:.2e}, " + ", ".join(line),
                  flush=True)
            del o_p, lse_p, ref
    del o_all, lse_all, delta_all
    # The ring against one whole-sequence call of the kernels.
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    whole_o = fa.flash_attention(*leaves, causal=True)
    whole = [whole_o] + list(torch.autograd.grad(whole_o, leaves, do))
    ring = ring_emulated(torch, fa, q, k, v, do, SP_HOPS)
    fault = ring_emulated(torch, fa, q, k, v, do, SP_HOPS, drop=(2, 1))

    def rel(a, w):
        return ((a.float() - w.float()).abs().max() /
                w.float().abs().max()).item()
    names = ("o", "dq", "dk", "dv")
    reading = {n: rel(a, w) for n, a, w in zip(names, ring, whole)}
    planted = {n: rel(a, w) for n, a, w in zip(names, fault, whole)}
    for n in names:
        print(f"  the ring's {n} vs one flash_attention call over the whole "
              f"sequence: {reading[n]:.3e} of the max < tolerance "
              f"{SP_RING_REL} < the ring with hop 1 of rank 2 dropped "
              f"{planted[n]:.3e}", flush=True)
        check(reading[n] <= SP_RING_REL < planted[n], f"(a) the ring's {n}:"
              f" reading {reading[n]}, fault {planted[n]}, tolerance "
              f"{SP_RING_REL}")
    del whole, ring, fault, leaves, whole_o

    records = []
    for name, tpu_line, source in (
            ("block_attn_fwd", 377, "autodist_tpu_torch/csrc/flash_fwd.cu"),
            ("block_attn_bwd", 397, "autodist_tpu_torch/csrc/flash_bwd.cu")):
        record = {"name": name, "route": "cuda", "source": source,
                  "replaces": f"autodist_tpu/ops/flash_attention.py:"
                              f"{tpu_line}",
                  "tpu_kernel": name,
                  "design": "a wrapper over the flash kernels with f32 "
                            "outputs at the hop's global offsets (one hop a "
                            "launch; the backward a dq and a dk/dv launch)",
                  "shape": [b, h, s, d], "max_abs_err": errs[name]}
        for hop, (r, j) in (("diagonal", (1, 1)), ("visible", (2, 0))):
            frac = (s + 1) / (2 * s) if r == j else 1.0
            pairs = float(b * h * s * s) * frac
            if name == "block_attn_fwd":
                args = (qs[r], ks[j], vs[j], True, r * s, j * s)
                kern = timed(torch, lambda: fa.block_attn_fwd(*args))
                plain = timed(torch, lambda: fa.flash_fwd_reference(
                    *args, out_dtype=f32))
                lib = timed(torch, lambda: sdpa(qs[r], ks[j], vs[j],
                                                is_causal=r == j))
                flops = 4.0 * pairs * d
                nbytes = 3 * qs[r].numel() * 2 + qs[r].numel() * 4 + \
                    b * h * s * 4
            else:
                bargs = (qs[r], ks[j], vs[j], dos[r], lses[r], deltas[r],
                         True, r * s, j * s)
                kern = timed(torch, lambda: fa.block_attn_bwd(*bargs))
                plain = timed(torch, lambda: fa.flash_bwd_reference(*bargs))
                sl = [x.detach().clone().requires_grad_()
                      for x in (qs[r], ks[j], vs[j])]
                out = sdpa(*sl, is_causal=r == j)
                lib = timed(torch, lambda: torch.autograd.grad(
                    out, sl, dos[r], retain_graph=True))
                # The function's work: five GEMMs a (q, k) pair (S
                # recomputed once, dP, dV, dQ, dK). The split kernels
                # recompute S and dP in each (6 + 8): that is not charged.
                flops = 10.0 * pairs * d
                nbytes = 4 * qs[r].numel() * 2 + 2 * b * h * s * 4 + \
                    3 * qs[r].numel() * 4
            bnd = bound(flops, nbytes)
            print(f"  {name}, the {hop} hop (q chunk {r}, k chunk {j}): "
                  f"device ms per call {kern['ms']:.4f}, host-inclusive "
                  f"{kern['host_ms']:.4f}; plain {plain['ms']:.4f}; SDPA "
                  f"({'causal' if r == j else 'non-causal'}"
                  f"{', backward' if name == 'block_attn_bwd' else ''}) "
                  f"{lib['ms']:.4f}; bound {bnd[0]:.4f} ({bnd[1]}: "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB); bound / "
                  f"kernel {bnd[0] / kern['ms']:.3f}; launches per call: "
                  f"{kernel_names(kern)}", flush=True)
            key = "" if hop == "diagonal" else "visible_"
            record.update({key + "ms": kern["ms"],
                           key + "host_ms": kern["host_ms"],
                           key + "plain_ms": plain["ms"],
                           key + "library_ms": lib["ms"],
                           key + "bound_ms": bnd[0],
                           key + "bound_by": bnd[1]})
        record["library"] = ("scaled_dot_product_attention, causal for the "
                             "diagonal hop, non-causal for visible_*")
        records.append(record)
    return records


def sp_train_rank(rank, world, port, spec):
    """One rank of :func:`sp_phase`: a gloo world over ``localhost`` on
    device 0; the LM of ``spec`` trains ``SP_STEPS`` eager SGD steps under
    SequenceParallel("ring"), ("ulysses") and the ring with each rank's
    attention local to its chunk (the planted fault). Prints {run: losses,
    launches, mesh, update error against the reference, ms per step,
    params digest}."""
    import datetime
    import hashlib
    import importlib
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    ra = importlib.import_module("autodist_tpu_torch.parallel.ring_attention")
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
        torch, spec["dtype"])))
    params, init = _lm_init(torch, cfg, device)
    tokens = sp_tokens(cfg, spec["batch"], spec["seq"])
    ref = torch.load(spec["ref"], map_location=device)
    out = {"rank": rank}
    real = ra.ring_attention
    for key, attn in (("ring", "ring"), ("ulysses", "ulysses"),
                      ("local", "ring")):
        if key == "local":  # each rank attends within its own chunk
            ra.ring_attention = (lambda q, k, v, group=None, causal=False:
                                 fa.flash_attention(q, k, v, causal))
        try:
            losses, times, launches, mesh, final = _lm_train(
                torch, fa, cfg, device,
                S.SequenceParallel(attn=attn, seq_axis=world), params,
                tokens, spec["steps"], spec["lr"])
        finally:
            ra.ring_attention = real
        digest = hashlib.sha256()
        for name, t in sorted(final.items()):
            digest.update(t.detach().float().cpu().numpy().tobytes())
        out[key] = {"losses": losses, "launches": launches, "ms": times,
                    "mesh": mesh,
                    "update_error": update_error(torch, final, ref, init),
                    "digest": digest.hexdigest()}
        del final
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def sp_tokens(cfg, batch, seq):
    """The seeded (batch, seq + 1) token ids every run of phase 10 (b)
    trains on."""
    import torch
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randint(0, cfg.vocab, (batch, seq + 1)))


def _lm_train(torch, fa, cfg, device, builder, params, tokens, steps, lr):
    """``steps`` eager SGD steps of the LM under ``builder`` from
    ``params`` (the runner copies them): (losses, host ms per step,
    launches of the flash kernels and hop wrappers over the steps, the
    runner's program mesh, the final logical params by name)."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import lm
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device=device)
    runner = ad.create_distributed_session(ad.capture(
        lm.make_loss_fn(cfg), params,
        functools.partial(torch.optim.SGD, lr=lr), example_batch=(tokens,)))
    state = runner.create_state()
    _ring_counts(fa, reset=True)  # this run's main path
    losses, times = [], []
    for _ in range(steps):
        (state, m), ms = _timed(torch, device, lambda: runner.step(
            state, (tokens,)))
        losses.append(float(m["loss"]))
        times.append(ms)
    launches = _ring_counts(fa)
    final = flatten_params(runner.logical_params(state))
    mesh = dict(runner.program.mesh.shape)
    autodist_mod._reset_default()
    return losses, times, launches, mesh, final


def _lm_init(torch, cfg, device):
    """The LM's seeded params, and a copy of them by name."""
    from autodist_tpu_torch.models import lm
    params = lm.init(cfg, torch.Generator().manual_seed(0), device=device)
    return params, {n: t.detach().clone()
                    for n, t in flatten_params(params).items()}


def sp_phase(torch, fa, card, device, vocab=32000, dim=1024, heads=16,
             layers=SP_LAYERS, max_len=SP_MAX_LEN, batch=SP_BATCH,
             steps=SP_STEPS):
    """Phase 10 (b): ``SP_WORLD`` gloo ranks (processes of this script) on
    the one card train the LM under SequenceParallel("ring") and
    ("ulysses") through AutoDist -> Runner.step, each rank its chunk of the
    sequence; losses and the whole update are held to one rank's
    AllReduce() steps over the whole sequence (tolerances between that run
    again and the block-diagonal fault), the ranks' params must agree
    bitwise, and every layer launches the kernels its attention needs.
    Returns {path: launches summed over the ranks}."""
    import tempfile
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    cfg = T.TransformerConfig(vocab=vocab, dim=dim, num_heads=heads,
                              num_layers=layers, max_len=max_len,
                              causal=True, dtype=torch.bfloat16)
    seq = max_len
    tokens = sp_tokens(cfg, batch, seq)
    print(f"phase 10 (b): {SP_WORLD} gloo ranks on one device, an LM at "
          f"lm1b's widths (vocab {vocab}, dim {dim}, {heads} heads), "
          f"{layers} layers, batch {batch} x {seq} tokens ({seq // SP_WORLD}"
          f" a rank), SGD {SP_LR}, {steps} eager steps under "
          f"SequenceParallel('ring') and ('ulysses') vs one rank's "
          f"AllReduce() over the whole sequence", flush=True)
    params, init = _lm_init(torch, cfg, device)
    ref = _lm_train(torch, fa, cfg, device, S.AllReduce(), params, tokens,
                    steps, SP_LR)
    again = _lm_train(torch, fa, cfg, device, S.AllReduce(), params, tokens,
                      steps, SP_LR)
    del params
    for name, n in ref[2].items():
        want = 0 if name.startswith("block") else layers * steps
        check(n == want, f"(b) one rank: {name} launched {n} times")
    floor_loss = _rel(again[0], ref[0])
    floor_update = update_error(torch, again[4], ref[4], init)
    check(all(np.isfinite(ref[0])) and ref[0][-1] < ref[0][0],
          f"(b) one rank's losses {ref[0]}")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    ref_path = os.path.join(tmp.name, "ref.pt")
    torch.save({n: t.detach().cpu() for n, t in ref[4].items()}, ref_path)
    ref_losses, ref_ms = ref[0], ref[1]
    del ref, again, init
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = json.dumps({"device": device, "config": fields,
                       "dtype": str(cfg.dtype).split(".")[-1], "seq": seq,
                       "batch": batch, "steps": steps, "lr": SP_LR,
                       "ref": ref_path})
    try:
        ranks = _spawn_ranks(SP_WORLD, "--sp-train", spec, "an SP rank",
                             timeout=600)
    finally:
        tmp.cleanup()
    got = {key: [r[key] for r in ranks] for key in ("ring", "ulysses",
                                                     "local")}
    fault_loss = _rel(got["local"][0]["losses"], ref_losses)
    fault_update = got["local"][0]["update_error"]
    print(f"  one rank AllReduce() over the whole sequence: losses "
          f"{', '.join(f'{x:.6f}' for x in ref_losses)}, ms per step "
          f"{', '.join(f'{x:.1f}' for x in ref_ms)}; floor (the run again): "
          f"loss {floor_loss:.3e}, update {floor_update:.3e}; planted "
          f"fault (attention local to each rank's chunk): loss "
          f"{fault_loss:.3e}, update {fault_update:.3e}", flush=True)
    paths, readings = {}, {}
    for key in ("ring", "ulysses"):
        runs = got[key]
        losses = runs[0]["losses"]
        rel = _rel(losses, ref_losses)
        err = runs[0]["update_error"]
        print(f"  SequenceParallel('{key}') on {SP_WORLD} ranks (mesh "
              f"{runs[0]['mesh']}): losses "
              f"{', '.join(f'{x:.6f}' for x in losses)}; max rel. diff "
              f"{rel:.3e} (tol {SP_LOSS_RTOL}); update error {err:.3e} (tol "
              f"{SP_UPDATE_RTOL}); ms per step "
              f"{', '.join(f'{x:.1f}' for x in runs[0]['ms'])}; params "
              f"equal on every rank: "
              f"{len({r['digest'] for r in runs}) == 1}; launches per rank "
              f"{runs[0]['launches']}", flush=True)
        readings[key] = (rel, err)
    for what, tol, floor, fault, i in (
            ("loss", SP_LOSS_RTOL, floor_loss, fault_loss, 0),
            ("update", SP_UPDATE_RTOL, floor_update, fault_update, 1)):
        check(floor < tol < fault, f"(b) the {what} tolerance {tol} does not"
              f" lie between the floor {floor} and the fault {fault}")
        for key, got_key in readings.items():
            check(got_key[i] <= tol, f"(b) {key}: the {what} reads "
                  f"{got_key[i]} (tolerance {tol})")
    for key, per_layer in (("ring", SP_WORLD), ("ulysses", 1)):
        runs = got[key]
        losses = runs[0]["losses"]
        check(all(r["losses"] == losses for r in runs),
              f"{key}: the ranks' losses differ")
        check(len({r["digest"] for r in runs}) == 1,
              f"{key}: the ranks' params differ")
        check(all(r["mesh"] == {"data": 1, "seq": SP_WORLD} for r in runs),
              f"{key}: mesh {runs[0]['mesh']}")
        want = {"flash_fwd": layers * steps * per_layer,
                "flash_bwd_dq": layers * steps * per_layer,
                "flash_bwd_dkv": layers * steps * per_layer,
                "block_attn_fwd": layers * steps * SP_WORLD * (key == "ring"),
                "block_attn_bwd": layers * steps * SP_WORLD * (key == "ring")}
        for r in runs:
            check(r["launches"] == want, f"{key}: launches {r['launches']}, "
                  f"expected {want}")
        paths[f"sp_gloo{SP_WORLD}_{key}"] = {
            k: sum(r["launches"][k] for r in runs) for k in want}
    return paths


# Phase 11: tensor parallelism.

def tp_kernel_phase(torch, fa, shape=TP_SHAPE, key="tp", label="(b)",
                    who="a TP rank's heads", causal=False):
    """Phase 11 (b): the three flash kernels at a tensor-parallel rank's
    attention shape (``TP_SHAPE``: BERT-base's 12 heads over a model axis
    of 2; phase 14 (c) gives Ulysses' shape under TP, phase 17 (c) a PP x
    TP rank's, ``causal``) against their plain versions on the same inputs
    (the training path's calls: f32 and bf16 o from one forward launch,
    bf16 gradients), then timed beside the plain versions, SDPA and the
    bound (under ``causal`` the visible (q, k) pairs only). Returns
    {kernel name: fields for its record, prefixed ``key``}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    b, h, sq, sk, d = shape
    bf16, f32 = torch.bfloat16, torch.float32
    q, k, v, do = [torch.randn((b, h, s, d), generator=gen, device=dev,
                               dtype=bf16) for s in (sq, sk, sk, sq)]
    o, lse, o_low = fa.flash_fwd(q, k, v, causal, out_dtype=f32,
                                 with_lowp=True)
    ro, rl = fa.flash_fwd_reference(q, k, v, causal, out_dtype=f32)
    errs = {"flash_fwd": float((o - ro).abs().max())}
    check(errs["flash_fwd"] <= O_F32_ATOL and
          float((lse - rl).abs().max()) <= LSE_ATOL and
          torch.equal(o_low, o.to(bf16)),
          f"flash_fwd at {shape}: o off by {errs['flash_fwd']}")
    delta = (do.float() * o).sum(-1, keepdim=True)
    args = (q, k, v, do, lse, delta)
    ref = fa.flash_bwd_reference(*args, causal)
    # f32 gradients against the plain version (phase 2's tolerances); the
    # training path's bf16 gradients bitwise those cast.
    for name, f32_out, bf16_out, want, tols in (
            ("flash_bwd_dq", (fa.flash_bwd_dq(*args, causal),),
             (fa.flash_bwd_dq(*args, causal, out_dtype=bf16),), ref[:1],
             (BWD_REL_DQDK_BF16,)),
            ("flash_bwd_dkv", fa.flash_bwd_dkv(*args, causal),
             fa.flash_bwd_dkv(*args, causal, out_dtype=bf16), ref[1:],
             (BWD_REL_DQDK_BF16, BWD_REL_DV_BF16))):
        errs[name] = 0.0
        for g, low, w, t in zip(f32_out, bf16_out, want, tols):
            err = float((g - w).abs().max())
            errs[name] = max(errs[name], err)
            check(err <= t * float(w.abs().max()) and
                  torch.equal(low, g.to(bf16)),
                  f"{name} at {shape}: off by {err}, or its bf16 "
                  f"gradients are not its f32 ones cast")
    # The visible (q, k) pairs: under causal (sq == sk) the lower triangle.
    pairs = float(b * h * d) * (sq * (sq + 1) / 2 if causal else sq * sk)
    ins = sum(x.numel() * x.element_size() for x in args)
    fwd_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, o, lse,
                                                          o_low))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=causal)
    runs = {
        "flash_fwd": (
            lambda: fa.flash_fwd(q, k, v, causal, out_dtype=f32,
                                 with_lowp=True),
            lambda: fa.flash_fwd_reference(q, k, v, causal, out_dtype=f32),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal),
            bound(4 * pairs, fwd_bytes), "the forward"),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(*args, causal, out_dtype=bf16),
            lambda: fa.flash_bwd_reference(*args, causal),
            lambda: torch.autograd.grad(sdpa_out, leaves, do,
                                        retain_graph=True),
            bound(6 * pairs, ins + q.numel() * 2), "dq, dk and dv together"),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(*args, causal, out_dtype=bf16),
            lambda: fa.flash_bwd_reference(*args, causal),
            lambda: torch.autograd.grad(sdpa_out, leaves, do,
                                        retain_graph=True),
            bound(8 * pairs, ins + 2 * k.numel() * 2),
            "dq, dk and dv together")}
    out = {}
    for name, (kern_fn, plain_fn, lib_fn, bnd, covers) in runs.items():
        kern, plain, lib = (timed(torch, f) for f in (kern_fn, plain_fn,
                                                      lib_fn))
        check(all(name + "_wgmma" in n for n in kern["kernels"]),
              f"{name} at {shape} launched {kernel_names(kern)}")
        print(f"  {label} {name} at b{b} h{h} s{sq} d{d} bf16 ({who}), "
              f"device ms per call (profiler, {TIMED_CALLS} calls) / "
              f"host-inclusive ms per call (events): kernel "
              f"{kern['ms']:.4f} / {kern['host_ms']:.4f}, plain "
              f"{plain['ms']:.4f} / {plain['host_ms']:.4f}, SDPA ({covers})"
              f" {lib['ms']:.4f} / {lib['host_ms']:.4f}; bound "
              f"{bnd[0]:.4f} ({bnd[1]}); bound / kernel "
              f"{bnd[0] / kern['ms']:.3f}; max abs err {errs[name]:.3e}",
              flush=True)
        out[name] = {f"{key}_{field}": value for field, value in (
            ("shape", [b, h, sq, d]), ("ms", kern["ms"]),
            ("host_ms", kern["host_ms"]), ("plain_ms", plain["ms"]),
            ("plain_host_ms", plain["host_ms"]), ("library_ms", lib["ms"]),
            ("library_host_ms", lib["host_ms"]), ("bound_ms", bnd[0]),
            ("bound_by", bnd[1]), ("max_abs_err", errs[name]))}
    return out


def _digest(torch, tensors):
    """sha256 of the tensors' bytes, in the given order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _collective_ms(torch, device, fn, n=10):
    """Host-inclusive ms per call of a collective, over ``n`` calls after
    one warm-up."""
    fn()
    _, ms = _timed(torch, device, lambda: [fn() for _ in range(n)])
    return ms / n


def tp_train_rank(rank, world, port, spec):
    """One rank of :func:`tp_phase`: a gloo world over ``localhost`` on
    device 0; BERT (``spec``'s config, the seeded init, the whole batch)
    trains ``TP_STEPS`` eager SGD steps under ModelParallel over each base
    of ``TP_BUILDERS`` and, over AllReduce, with each fault of
    ``TP_FAULTS`` monkeypatched in; the AllReduce run is saved through
    ``CheckpointManager`` into ``spec["ckpt"]``. Prints {run: losses,
    launches, ms, mesh, kinds, update error against the reference,
    digests of the replicated params and of the pieces, stored and whole
    parameter bytes, peak memory}, the logical params' digest per leaf and
    the model group's collective times."""
    import datetime
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import bert, layers
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.parallel import collectives
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
        torch, spec["dtype"])))
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
    init = {n: t.detach().clone() for n, t in flatten_params(params).items()}
    batch = bert.synthetic_batch(cfg, spec["batch"], spec["seq"],
                                 spec["masked"], seed=0)
    ref = torch.load(spec["ref"], map_location=device)

    def undivided(ctx, grad):
        return (collectives.reduce_scatter(grad, ctx.dim, ctx.group), None,
                None, None)
    faults = {"undivided": (collectives.GatherShards, "backward",
                            staticmethod(undivided)),
              "no_allreduce": (layers._CopyToModel, "backward",
                               staticmethod(lambda ctx, grad: (grad, None)))}
    out = {"rank": rank}
    for key in [k for k, _ in TP_BUILDERS] + list(TP_FAULTS):
        base = dict(TP_BUILDERS).get(key, "AllReduce")
        patch = faults.get(key)
        if patch is not None:
            real = patch[0].__dict__[patch[1]]
            setattr(patch[0], patch[1], patch[2])
        try:
            run = _train(torch, fa, device, S.ModelParallel(
                getattr(S, base)(), model_axis=world), bert.make_loss_fn(cfg),
                params, batch, spec["steps"], TP_LR)
        finally:
            if patch is not None:
                setattr(patch[0], patch[1], real)
        kinds = run.runner.var_kinds
        final = flatten_params(run.runner.logical_params(run.state))
        stored = flatten_params(run.state.params)
        out[key] = {
            "losses": run.losses, "launches": run.launches, "ms": run.times,
            "mesh": dict(run.runner.program.mesh.shape),
            "kinds": sorted({k for k, _ in kinds.values()}),
            "update_error": update_error(torch, final, ref, init),
            "replicated": _digest(torch, (t for n, t in sorted(stored.items())
                                  if kinds[n][0] != "tp")),
            "pieces": _digest(torch, (t for n, t in sorted(stored.items())
                                      if kinds[n][0] == "tp")),
            "stored_bytes": sum(t.numel() * t.element_size()
                                for t in stored.values()),
            "whole_bytes": sum(t.numel() * t.element_size()
                               for t in final.values()),
            "stored_params": sum(t.numel() for t in stored.values()),
            "whole_params": sum(t.numel() for t in final.values()),
            "peak_bytes": run.peak}
        if key == "allreduce":
            mgr = CheckpointManager(run.runner, spec["ckpt"])
            mgr.save(spec["steps"], run.state, force=True)
            mgr.wait_until_finished()
            mgr.close()
            out["logical"] = {n: _digest(torch, [t]) for n, t in final.items()}
            group = run.runner.program.mesh.group("model")
            act = torch.zeros((spec["batch"], spec["seq"], cfg.dim),
                              dtype=cfg.dtype, device=device)
            table = stored["embed/embedding"]
            out["allreduce_ms"] = _collective_ms(
                torch, device, lambda: dist.all_reduce(act, group=group))
            out["gather_ms"] = _collective_ms(
                torch, device, lambda: collectives.all_gather(
                    table, 1, group))
            out["gather_bytes"] = table.numel() * table.element_size() * \
                world
        del run, final, stored
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def tp_phase(torch, fa, card, cfg, device, batch_size=32, seq=128,
             num_masked=20, steps=TP_STEPS):
    """Phase 11 (a), (c), (d): ``TP_WORLD`` gloo ranks (processes of this
    script) on the one card train ``cfg`` under ModelParallel over each
    base of ``TP_BUILDERS`` through AutoDist -> Runner.step; held to one
    rank's AllReduce() steps (tolerances between that run again and the
    planted faults), the replicated params bitwise equal across the ranks,
    every layer's flash kernels launched once a step on each rank; then the
    AllReduce run's checkpoint restores into one rank bitwise and serves.
    Returns {path: flash launches, summed over the ranks}."""
    import tempfile
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    t_phase = time.perf_counter()
    print(f"phase 11: {TP_WORLD} gloo ranks on one device, BERT at width "
          f"{cfg.dim}, {cfg.num_heads} heads, {cfg.num_layers} layers "
          f"(vocab {cfg.vocab}, max_len {cfg.max_len}; MLM batch "
          f"{batch_size} x {seq}, SGD {TP_LR}), {steps} eager steps under "
          + ", ".join(f"ModelParallel({b}(), model_axis={TP_WORLD})"
                      for _, b in TP_BUILDERS) +
          f" on {{data: 1, model: {TP_WORLD}}} vs one rank's AllReduce()",
          flush=True)
    batch = bert.synthetic_batch(cfg, batch_size, seq, num_masked, seed=0)
    try:
        ref = strategy_run(torch, fa, cfg, device, "one rank AllReduce()",
                           S.AllReduce(), batch, steps, optimizer="SGD",
                           lr=TP_LR)
        again = strategy_run(torch, fa, cfg, device,
                             "one rank AllReduce() again", S.AllReduce(),
                             batch, steps, optimizer="SGD", lr=TP_LR)
    finally:
        autodist_mod._reset_default()
    floor = {"loss": _rel(again.losses, ref.losses),
             "update": update_error(torch, again.params, ref.params,
                                    ref.init)}
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    ref_path = os.path.join(tmp.name, "ref.pt")
    ckpt = os.path.join(tmp.name, "tp_ckpt")
    torch.save({n: t.detach().cpu() for n, t in ref.params.items()},
               ref_path)
    ref_losses, ref_ms = ref.losses, ref.times
    del ref, again
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = json.dumps({"device": device, "config": fields,
                       "dtype": str(cfg.dtype).split(".")[-1], "seq": seq,
                       "batch": batch_size, "masked": num_masked,
                       "steps": steps, "ref": ref_path, "ckpt": ckpt})
    try:
        ranks = _spawn_ranks(TP_WORLD, "--tp-train", spec, "a TP rank")
        faults = {key: (_rel(ranks[0][key]["losses"], ref_losses),
                        ranks[0][key]["update_error"]) for key in TP_FAULTS}
        print(f"  one rank AllReduce(): losses "
              f"{', '.join(f'{x:.6f}' for x in ref_losses)}, ms per step "
              f"{', '.join(f'{x:.1f}' for x in ref_ms)}; floor (the run "
              f"again): loss {floor['loss']:.3e}, update "
              f"{floor['update']:.3e}; planted faults: " + "; ".join(
                  f"{key}: loss {l:.3e}, update {u:.3e}"
                  for key, (l, u) in faults.items()) + f" (on {card})",
              flush=True)
        for i, (what, tol) in enumerate((("loss", TP_LOSS_RTOL),
                                         ("update", TP_UPDATE_RTOL))):
            least = min(f[i] for f in faults.values())
            check(floor[what] < tol < least, f"(a) the {what} tolerance "
                  f"{tol} does not lie between the floor {floor[what]} and "
                  f"the faults' least reading {least}")
        paths = {}
        for key, base in TP_BUILDERS:
            runs = [r[key] for r in ranks]
            losses = runs[0]["losses"]
            rel = _rel(losses, ref_losses)
            err = runs[0]["update_error"]
            stored = runs[0]["stored_bytes"] / runs[0]["whole_bytes"]
            print(f"  ModelParallel({base}()) on {TP_WORLD} ranks (mesh "
                  f"{runs[0]['mesh']}, kinds {'/'.join(runs[0]['kinds'])}): "
                  f"losses {', '.join(f'{x:.6f}' for x in losses)}; max rel. "
                  f"diff {rel:.3e} (tol {TP_LOSS_RTOL}); update error "
                  f"{err:.3e} (tol {TP_UPDATE_RTOL}); replicated params "
                  f"equal on every rank: "
                  f"{len({r['replicated'] for r in runs}) == 1}, pieces "
                  f"differ: {len({r['pieces'] for r in runs}) == TP_WORLD}; "
                  f"flash launches per rank {runs[0]['launches']}", flush=True)
            for r in runs:
                print(f"    rank {runs.index(r)}: stores "
                      f"{r['stored_params'] / 1e6:.2f} M of "
                      f"{r['whole_params'] / 1e6:.2f} M parameters "
                      f"({r['stored_bytes']} of {r['whole_bytes']} bytes, "
                      f"{100 * r['stored_bytes'] / r['whole_bytes']:.1f}%); "
                      f"peak memory {r['peak_bytes'] / 2**30:.2f} GiB; ms "
                      f"per step (host-inclusive) "
                      f"{', '.join(f'{x:.1f}' for x in r['ms'])}; on {card}",
                      flush=True)
            check(rel <= TP_LOSS_RTOL, f"(a) {base}: losses {losses} vs one "
                  f"rank's {ref_losses}")
            check(err <= TP_UPDATE_RTOL, f"(a) {base}: update error {err}")
            check(all(r["losses"] == losses for r in runs),
                  f"(a) {base}: the ranks' losses differ")
            check(len({r["replicated"] for r in runs}) == 1,
                  f"(a) {base}: the replicated params differ across ranks")
            check(len({r["pieces"] for r in runs}) == TP_WORLD,
                  f"(a) {base}: two ranks hold the same pieces")
            check(all(r["mesh"] == {"data": 1, "model": TP_WORLD}
                      for r in runs), f"(a) {base}: mesh {runs[0]['mesh']}")
            check(0.45 < stored < 0.55, f"(a) {base}: a rank stores "
                  f"{stored:.3f} of the parameter bytes")
            want = {name: cfg.num_layers * steps for name in
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
            for r in runs:
                check(r["launches"] == want, f"(a) {base}: launches "
                      f"{r['launches']}, expected {want}")
            paths[f"tp_gloo{TP_WORLD}_{key}"] = {
                k: sum(r["launches"][k] for r in runs) for k in want}
        print(f"  (b) the model group's collectives on gloo (CUDA tensors, "
              f"host-inclusive): activation all-reduce of {batch_size} x "
              f"{seq} x {cfg.dim} {str(cfg.dtype)[6:]} "
              f"{ranks[0]['allreduce_ms']:.2f} ms (4 a layer a step: 2 "
              f"forward, 2 backward); embedding table gather "
              f"({ranks[0]['gather_bytes'] / 1e6:.1f} MB gathered) "
              f"{ranks[0]['gather_ms']:.2f} ms (and its reduce-scatter in "
              f"the backward); on {card}", flush=True)

        # (c) the checkpoint round trip.
        autodist_mod._reset_default()
        ad = AutoDist(strategy_builder=S.AllReduce(), device=device)
        runner = ad.create_distributed_session(ad.capture(
            bert.make_loss_fn(cfg), bert.init(
                cfg, torch.Generator().manual_seed(0), device=device),
            functools.partial(torch.optim.SGD, lr=TP_LR),
            example_batch=batch))
        state = CheckpointManager(runner, ckpt).restore_or_init()
        got = {n: _digest(torch, [t]) for n, t in
               flatten_params(runner.logical_params(state)).items()}
        check(got == ranks[0]["logical"], f"(c) the restored leaves "
              f"{sorted(n for n in got if got[n] != ranks[0]['logical'].get(n))[:5]} "
              f"are not bitwise the TP world's logical params")
        print(f"  (c) the TP world's checkpoint (step {steps}) restored into "
              f"a one-rank AllReduce() Runner: {len(got)} leaves bitwise the "
              f"TP world's logical params", flush=True)
        rng = np.random.RandomState(11)
        request = (rng.randint(0, cfg.vocab, (8, cfg.max_len)).astype(
            np.int32), rng.randint(0, 2, (8, cfg.max_len)).astype(np.int32))
        with torch.inference_mode():
            want = T.encode(runner.logical_params(state), cfg,
                            torch.as_tensor(request[0], device=device),
                            segment_ids=torch.as_tensor(
                                request[1], device=device)).float().cpu()
        del state, runner
        autodist_mod._reset_default()
        paths["tp_serve_restored"] = {
            "flash_fwd": resilience_serve(
                torch, fa, card, cfg, device,
                CheckpointManager(None, ckpt).restore_params(), want, request,
                label="(c)"),
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    finally:
        autodist_mod._reset_default()
        tmp.cleanup()
    print(f"  (d) phase 11 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def ep_config(torch, d_model=EP_D, d_hidden=EP_H, num_experts=EP_E):
    from autodist_tpu_torch.parallel import moe
    return moe.MoEConfig(num_experts=num_experts, top_k=2, d_model=d_model,
                         d_hidden=d_hidden, dtype=torch.bfloat16)


def ep_init(torch, cfg, device):
    """{"moe": the layer, "head": (d, EP_CLASSES) * 0.1} from seed 0."""
    from autodist_tpu_torch.parallel import moe
    gen = torch.Generator().manual_seed(0)
    return {"moe": moe.init(gen, cfg, device=device),
            "head": {"kernel": (torch.randn(
                (cfg.d_model, EP_CLASSES), generator=gen) * 0.1).to(device)}}


def ep_batch(torch, cfg, batch, seq, device):
    """(x (batch, seq, d) f32, labels (batch, seq) int64) from seed 0."""
    rng = np.random.RandomState(0)
    return (torch.as_tensor(rng.randn(batch, seq, cfg.d_model).astype(
                np.float32), device=device),
            torch.as_tensor(rng.randint(0, EP_CLASSES, (batch, seq)),
                            device=device))


def ep_loss(cfg):
    """The JAX package's MoE training loss: moe.apply -> head -> mean
    cross-entropy over the tokens + 0.01 aux."""
    import torch.nn.functional as F
    from autodist_tpu_torch.parallel import moe

    def loss_fn(params, batch):
        x, labels = batch
        h, aux = moe.apply(params["moe"], cfg, x)
        logits = h @ params["head"]["kernel"]
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1)) + 0.01 * aux
    return loss_fn


def update_errors(torch, got, ref, init):
    """{param: the relative L2 error of its update}, ||got - ref|| / ||ref
    - init||, by name."""
    return {n: update_error(torch, {n: got[n]}, {n: ref[n]}, {n: init[n]})
            for n in ref}


def _bmm_recorder(torch):
    """A dispatch mode recording every bmm's leading (expert) dim in its
    ``lead`` list and its second operand's shape in ``shapes``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.lead, self.shapes = [], []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default:
                self.lead.append(int(args[0].shape[0]))
                self.shapes.append(list(args[1].shape))
            return func(*args, **(kwargs or {}))
    return Record()


def _ep_train(torch, fa, cfg, device, builder, params, batch, steps,
              aot=False, record=False):
    """``steps`` SGD steps of :func:`ep_loss` under ``builder`` from
    ``params`` (the runner copies them), eagerly or through
    ``make_callable(aot=True)``: the losses, host ms per step, flash
    launches over the steps, peak device memory, the runner, the state, the
    step function, the item's ``flops_estimate`` and, with ``record``, the
    leading dims of step 1's bmms and their weights' shapes."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device=device)
    item = ad.capture(ep_loss(cfg), params,
                      functools.partial(torch.optim.SGD, lr=EP_LR),
                      example_batch=batch)
    runner = ad.create_distributed_session(item)
    state = runner.create_state()
    dbatch = runner.remapper.shard_batch(batch)
    step_fn = runner.make_callable(batch, aot=aot)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _flash_counts(fa, reset=True)  # this run's main path
    losses, times, lead, shapes = [], [], [], []
    for i in range(steps):
        rec = _bmm_recorder(torch) if record and i == 0 else \
            contextlib.nullcontext()
        with rec:
            (state, m), ms = _timed(torch, device, lambda: step_fn(
                state, dbatch))
        if record and i == 0:
            lead, shapes = rec.lead, rec.shapes
        losses.append(float(m["loss"]))
        times.append(ms)
    return types.SimpleNamespace(
        losses=losses, times=times, launches=_flash_counts(fa),
        peak=torch.cuda.max_memory_allocated() if device == "cuda" else 0,
        runner=runner, state=state, step_fn=step_fn,
        flops=item.flops_estimate(), lead=lead, shapes=shapes)


def ep_train_rank(rank, world, port, spec):
    """One rank of :func:`ep_phase`: a gloo world over ``localhost`` on
    device 0; the MoE model (``spec``'s widths, the seeded init, the whole
    batch) trains ``spec["steps"]`` eager SGD steps under
    ModelParallel(rules=moe.EXPERT_RULES, mesh_axis="expert") over each
    base of ``EP_BUILDERS`` and, over AllReduce, with each fault of
    ``EP_FAULTS`` monkeypatched in; the AllReduce run is saved through
    ``CheckpointManager`` into ``spec["ckpt"]`` and then takes one more
    step, whose loss is that of the saved params. Prints {run: losses,
    launches, ms, mesh, kinds, each param's update error against the
    reference, digests of the replicated params, of the pieces and of each
    step's top-k indices, step 1's bmm leading dims, stored and whole
    parameter bytes, peak memory}, the logical params' digest per leaf and
    the expert group's all-reduce time."""
    import datetime
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import layers
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.parallel import collectives, context, moe
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    cfg = ep_config(torch, **spec["widths"])
    params = ep_init(torch, cfg, device)
    init = {n: t.detach().clone() for n, t in flatten_params(params).items()}
    batch = ep_batch(torch, cfg, spec["batch"], spec["seq"], device)
    ref = torch.load(spec["ref"], map_location=device)
    real_route = moe._route
    routes = []

    def recorded(gates, cfg, group=None):
        out = real_route(gates, cfg, group)
        routes.append(_digest(torch, [out[1]]))
        return out

    def aux_summed(gates, cfg, group=None):
        top_vals, top_idx, _ = real_route(gates, cfg, group)
        _, _, aux = real_route(layers.copy_to_model(
            gates, context.current().expert_group), cfg, group)
        return top_vals, top_idx, aux

    def undivided(ctx, grad):
        return (collectives.reduce_scatter(grad, ctx.dim, ctx.group), None,
                None, None)
    faults = {"no_copy": (layers._CopyToModel, "backward",
                          staticmethod(lambda ctx, grad: (grad, None))),
              "aux_summed": (moe, "_route", aux_summed),
              "undivided": (collectives.GatherShards, "backward",
                            staticmethod(undivided))}
    out = {"rank": rank}
    for key in [k for k, _ in EP_BUILDERS] + list(EP_FAULTS):
        base = dict(EP_BUILDERS).get(key, "AllReduce")
        target, attr, fault = faults.get(key, (moe, "_route", recorded))
        real = target.__dict__[attr]
        setattr(target, attr, fault)
        routes.clear()
        try:
            run = _ep_train(torch, fa, cfg, device, S.ModelParallel(
                getattr(S, base)(), model_axis=world, rules=moe.EXPERT_RULES,
                mesh_axis="expert"), params, batch, spec["steps"],
                record=key not in faults)
        finally:
            setattr(target, attr, real)
        kinds = run.runner.var_kinds
        final = flatten_params(run.runner.logical_params(run.state))
        stored = flatten_params(run.state.params)
        out[key] = {
            "losses": run.losses, "launches": run.launches, "ms": run.times,
            "mesh": dict(run.runner.program.mesh.shape),
            "kinds": sorted({k for k, _ in kinds.values()}),
            "update_errors": update_errors(torch, final, ref, init),
            "replicated": _digest(torch, (t for n, t in sorted(stored.items())
                                  if kinds[n][0] != "tp")),
            "pieces": _digest(torch, (t for n, t in sorted(stored.items())
                                      if kinds[n][0] == "tp")),
            "routes": list(routes), "bmm": run.lead,
            "stored_bytes": sum(t.numel() * t.element_size()
                                for t in stored.values()),
            "whole_bytes": sum(t.numel() * t.element_size()
                               for t in final.values()),
            "peak_bytes": run.peak}
        if key == "allreduce":
            mgr = CheckpointManager(run.runner, spec["ckpt"])
            mgr.save(spec["steps"], run.state, force=True)
            mgr.wait_until_finished()
            mgr.close()
            out["logical"] = {n: _digest(torch, [t]) for n, t in final.items()}
            _, m = run.step_fn(run.state, run.runner.remapper.shard_batch(
                batch))
            out["next_loss"] = float(m["loss"])
            group = run.runner.program.mesh.group("expert")
            partial = torch.zeros((spec["batch"] * spec["seq"],
                                   cfg.d_model), device=device)
            out["allreduce_ms"] = _collective_ms(
                torch, device, lambda: dist.all_reduce(partial, group=group))
            out["allreduce_bytes"] = partial.numel() * partial.element_size()
        del run, final, stored
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def ep_ffn_timing(torch, card, cfg, tokens, ep, model=1):
    """Prints the expert FFN's time (the two bmms and the GELU between
    them) on the card at its buffers' shapes: all E experts (one rank)
    and E/ep with h/``model`` hidden columns each (an expert-parallel
    rank, over a model axis too where ``model`` > 1), bf16, device ms
    against the bound of its operations."""
    import math
    import torch.nn.functional as F
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    cap = min(tokens, max(1, math.ceil(tokens * cfg.top_k / cfg.num_experts *
                                       cfg.capacity_factor)))
    for e, h in ((cfg.num_experts, cfg.d_hidden),
                 (cfg.num_experts // ep, cfg.d_hidden // model)):
        buf, up, down = [torch.randn(shape, generator=gen, device=dev,
                                     dtype=torch.bfloat16) for shape in (
            (e, cap, cfg.d_model), (e, cfg.d_model, h), (e, h, cfg.d_model))]
        t = timed(torch, lambda: torch.bmm(F.gelu(torch.bmm(
            buf, up), approximate="tanh"), down))
        flops = 2 * 2.0 * e * cap * cfg.d_model * h
        nbytes = 2 * (buf.numel() * 2 + up.numel() + down.numel())
        bnd = bound(flops, nbytes)
        print(f"  (c) expert FFN of {e} experts (buffer {e} x {cap} x "
              f"{cfg.d_model}, h {h}, bf16): device ms "
              f"{t['ms']:.4f}, host-inclusive {t['host_ms']:.4f}; "
              f"{flops / 1e9:.1f} GFLOP, bound {bnd[0]:.4f} ms ({bnd[1]}); "
              f"bound / device {bnd[0] / t['ms']:.3f}; on {card}",
              flush=True)


def ep_phase(torch, fa, card, device, widths=None, batch_size=EP_BATCH,
             seq=EP_SEQ, steps=EP_STEPS, share=None):
    """Phase 12: (a) one rank trains the MoE model eagerly, again, and
    through make_callable(aot=True); (b) ``EP_WORLD`` gloo ranks (processes
    of this script) on the one card train it under
    ModelParallel(rules=moe.EXPERT_RULES, mesh_axis="expert") over each
    base of ``EP_BUILDERS`` through AutoDist -> Runner.step, held to one
    rank's AllReduce() steps (tolerances between that run again and the
    planted faults), the replicated params bitwise equal across the ranks,
    the top-k indices equal at every step, each rank's expert products on
    E/ep experts; (c) memory, step and expert FFN times; (d) the AllReduce
    run's checkpoint restores into one rank bitwise and its forward gives
    the EP step's loss; (e) the phase's seconds. Returns {path: flash
    launches} (none: the path has no attention). ``share`` ({"dir": a
    directory}) receives the one-rank reference for phase 17:
    ``share["ep_reference"]`` = (losses, (floor loss, floor update), path
    of the final params)."""
    import tempfile
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.ops import build
    t_phase = time.perf_counter()
    widths = widths or {}
    cfg = ep_config(torch, **widths)
    tokens = batch_size * seq
    print(f"phase 12: an MoE layer at Switch-Base-8's widths (d_model "
          f"{cfg.d_model}, d_ff {cfg.d_hidden}, {cfg.num_experts} experts, "
          f"top_k {cfg.top_k}, cf {cfg.capacity_factor}, bf16 compute) -> a "
          f"{EP_CLASSES}-class head, CE + 0.01 aux, x {batch_size} x {seq} x "
          f"{cfg.d_model}, SGD {EP_LR}, {steps} steps: one rank eager and "
          f"aot=True, then {EP_WORLD} gloo ranks under " + ", ".join(
              f"ModelParallel({b}(), model_axis={EP_WORLD}, "
              f"rules=moe.EXPERT_RULES, mesh_axis='expert')"
              for _, b in EP_BUILDERS), flush=True)
    batch = ep_batch(torch, cfg, batch_size, seq, "cpu")
    params = ep_init(torch, cfg, device)
    init = {n: t.detach().clone() for n, t in flatten_params(params).items()}
    paths = {}
    try:
        runs = {label: _ep_train(torch, fa, cfg, device, S.AllReduce(),
                                 params, batch, steps, aot=aot)
                for label, aot in (("eager", False), ("again", False),
                                   ("aot", True))}
        finals = {label: flatten_params(r.runner.logical_params(r.state))
                  for label, r in runs.items()}
        ref = runs["eager"]
        expert_flops = 2 * 2.0 * tokens * cfg.top_k * \
            cfg.capacity_factor * cfg.d_model * cfg.d_hidden
        for label, r in runs.items():
            check(all(np.isfinite(r.losses)) and r.losses[-1] < r.losses[0],
                  f"(a) one rank {label}: losses {r.losses}")
            check(not any(r.launches.values()), f"(a) one rank {label}: "
                  f"flash launches {r.launches} on a path with none")
        check(all(not torch.equal(init[n], finals["eager"][n])
                  for n in init), "(a) a param did not change")
        aot = runs["aot"]
        if device == "cuda":
            graph = aot.step_fn.graph
            check(graph.captured and graph.replays == steps - 1,
                  f"(a) the aot step replayed {graph.replays} times in "
                  f"{steps} calls")
        floor = {"loss": _rel(runs["again"].losses, ref.losses),
                 "update": max(update_errors(torch, finals["again"],
                                             finals["eager"], init).values())}
        aot_rel = _rel(aot.losses, ref.losses)
        print(f"  (a) one rank AllReduce(): losses "
              f"{', '.join(f'{x:.6f}' for x in ref.losses)}; ms per step "
              f"(host-inclusive) eager "
              f"{', '.join(f'{x:.1f}' for x in ref.times)}, aot=True {', '.join(f'{x:.1f}' for x in aot.times)}; "
              f"aot losses {', '.join(f'{x:.6f}' for x in aot.losses)}, max "
              f"rel. diff from eager {aot_rel:.3e}, step 1 bitwise: "
              f"{aot.losses[0] == ref.losses[0]}; floor (the run again): "
              f"loss {floor['loss']:.3e}, update {floor['update']:.3e}; peak "
              f"memory {ref.peak / 2**30:.2f} GiB; flops_estimate "
              f"{ref.flops / 1e9:.1f} GFLOP (the expert products "
              f"{expert_flops / 1e9:.1f}); on {card}", flush=True)
        check(aot.losses[0] == ref.losses[0], f"(a) the aot step 1 loss "
              f"{aot.losses[0]} is not the eager step's {ref.losses[0]}")
        check(aot_rel <= floor["loss"], f"(a) aot losses {aot.losses} vs "
              f"eager {ref.losses}: further apart than the eager run again "
              f"({floor['loss']})")
        check(ref.flops >= expert_flops, f"(a) flops_estimate {ref.flops} "
              f"misses the expert products' {expert_flops}")
        paths["ep_one_rank"] = ref.launches
        paths["ep_one_rank_aot"] = aot.launches
        ref_losses, ref_times = ref.losses, ref.times
        ref_final = {n: t.detach().cpu() for n, t in finals["eager"].items()}
        del runs, finals, ref, aot
    finally:
        autodist_mod._reset_default()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    ref_path = os.path.join(tmp.name, "ref.pt")
    ckpt = os.path.join(tmp.name, "ep_ckpt")
    torch.save(ref_final, ref_path)
    if share is not None:
        shutil.copy(ref_path, os.path.join(share["dir"], "ep_ref.pt"))
        share["ep_reference"] = (ref_losses, (floor["loss"],
                                              floor["update"]),
                                 os.path.join(share["dir"], "ep_ref.pt"))
    spec = json.dumps({"device": device, "widths": widths, "seq": seq,
                       "batch": batch_size, "steps": steps, "ref": ref_path,
                       "ckpt": ckpt})
    try:
        ranks = _spawn_ranks(EP_WORLD, "--ep-train", spec, "an EP rank")
        faults = {key: (_rel(ranks[0][key]["losses"], ref_losses),
                        max(ranks[0][key]["update_errors"].values()))
                  for key in EP_FAULTS}
        print(f"  (b) planted faults against one rank: " + "; ".join(
            f"{key}: loss {l:.3e}, update {u:.3e} (" + ", ".join(
                f"{n} {e:.2e}" for n, e in
                ranks[0][key]["update_errors"].items()) + ")"
            for key, (l, u) in faults.items()) + f" (on {card})", flush=True)
        for i, (what, tol, keys) in enumerate((
                ("loss", EP_LOSS_RTOL, EP_LOSS_FAULTS),
                ("update", EP_UPDATE_RTOL, EP_FAULTS))):
            least = min(faults[k][i] for k in keys)
            check(floor[what] < tol < least, f"(b) the {what} tolerance "
                  f"{tol} does not lie between the floor {floor[what]} and "
                  f"the faults' least reading {least}")
        local_e = cfg.num_experts // EP_WORLD
        for key, base in EP_BUILDERS:
            runs = [r[key] for r in ranks]
            losses = runs[0]["losses"]
            rel = _rel(losses, ref_losses)
            errs = runs[0]["update_errors"]
            err = max(errs.values())
            print(f"  (b) ModelParallel({base}(), mesh_axis='expert') on "
                  f"{EP_WORLD} ranks (mesh {runs[0]['mesh']}, kinds "
                  f"{'/'.join(runs[0]['kinds'])}): losses "
                  f"{', '.join(f'{x:.6f}' for x in losses)}; max rel. diff "
                  f"{rel:.3e} (tol {EP_LOSS_RTOL}); update errors "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) +
                  f" (tol {EP_UPDATE_RTOL}); replicated params equal on "
                  f"every rank: {len({r['replicated'] for r in runs}) == 1}, "
                  f"pieces differ: "
                  f"{len({r['pieces'] for r in runs}) == EP_WORLD}; top-k "
                  f"equal across the group at every step: "
                  f"{len({tuple(r['routes']) for r in runs}) == 1}; step 1's "
                  f"expert bmms on {sorted(set(runs[0]['bmm']))} experts",
                  flush=True)
            for i, r in enumerate(runs):
                print(f"    rank {i}: stores {r['stored_bytes']} of "
                      f"{r['whole_bytes']} parameter bytes "
                      f"({100 * r['stored_bytes'] / r['whole_bytes']:.1f}%); "
                      f"peak memory {r['peak_bytes'] / 2**30:.2f} GiB; ms per "
                      f"step (host-inclusive) "
                      f"{', '.join(f'{x:.1f}' for x in r['ms'])}; on {card}",
                      flush=True)
            check(rel <= EP_LOSS_RTOL, f"(b) {base}: losses {losses} vs one "
                  f"rank's {ref_losses}")
            check(err <= EP_UPDATE_RTOL, f"(b) {base}: update errors {errs}")
            check(all(r["losses"] == losses for r in runs),
                  f"(b) {base}: the ranks' losses differ")
            check(len({r["replicated"] for r in runs}) == 1,
                  f"(b) {base}: the replicated params differ across ranks")
            check(len({r["pieces"] for r in runs}) == EP_WORLD,
                  f"(b) {base}: two ranks hold the same pieces")
            check(all(len(r["routes"]) == steps for r in runs) and
                  len({tuple(r["routes"]) for r in runs}) == 1,
                  f"(b) {base}: the ranks' top-k indices differ")
            check(all(r["bmm"] and set(r["bmm"]) == {local_e} for r in runs),
                  f"(b) {base}: expert bmms on {runs[0]['bmm']} experts, "
                  f"expected {local_e}")
            check(all(r["mesh"] == {"data": 1, "expert": EP_WORLD}
                      for r in runs), f"(b) {base}: mesh {runs[0]['mesh']}")
            check(all(not any(r["launches"].values()) for r in runs),
                  f"(b) {base}: flash launches on a path with none")
            paths[f"ep_gloo{EP_WORLD}_{key}"] = {
                k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
        print(f"  (c) the expert group's all-reduce of the (T, d) f32 output "
              f"({ranks[0]['allreduce_bytes'] / 1e6:.1f} MB) on gloo ({device} "
              f"tensors, host-inclusive): {ranks[0]['allreduce_ms']:.2f} ms "
              f"(and one of the copy-to-expert gradients in the backward); "
              f"one rank's step {min(ref_times):.1f} ms (min of "
              f"{steps}); on {card}", flush=True)
        if device == "cuda":
            ep_ffn_timing(torch, card, cfg, tokens, EP_WORLD)

        # (d) the checkpoint round trip.
        autodist_mod._reset_default()
        ad = AutoDist(strategy_builder=S.AllReduce(), device=device)
        runner = ad.create_distributed_session(ad.capture(
            ep_loss(cfg), ep_init(torch, cfg, device),
            functools.partial(torch.optim.SGD, lr=EP_LR),
            example_batch=batch))
        state = CheckpointManager(runner, ckpt).restore_or_init()
        logical = runner.logical_params(state)
        got = {n: _digest(torch, [t]) for n, t in
               flatten_params(logical).items()}
        differ = sorted(n for n in got if got[n] != ranks[0]["logical"].get(n))
        check(not differ, f"(d) the restored leaves {differ} are not "
              f"bitwise the EP world's logical params")
        with torch.no_grad():
            loss = float(ep_loss(cfg)(logical, runner.remapper.shard_batch(
                batch)))
        rel = abs(loss - ranks[0]["next_loss"]) / abs(ranks[0]["next_loss"])
        print(f"  (d) the EP world's checkpoint (step {steps}) restored into "
              f"a one-rank AllReduce() Runner: {len(got)} leaves bitwise the "
              f"EP world's logical params; its forward's loss {loss:.6f} vs "
              f"the EP step's {ranks[0]['next_loss']:.6f} (rel. diff "
              f"{rel:.3e}, bitwise: {loss == ranks[0]['next_loss']})",
              flush=True)
        check(rel <= EP_LOSS_RTOL, f"(d) the restored forward's loss {loss} "
              f"vs the EP step's {ranks[0]['next_loss']}")
        del state, runner, logical
    finally:
        autodist_mod._reset_default()
        tmp.cleanup()
    print(f"  (e) phase 12 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


# Phase 13: pipeline parallelism.

def _train(torch, fa, device, builder, loss_fn, params, batch, steps, lr,
           aot=False, prepare=None, counts=None):
    """``steps`` SGD steps of ``loss_fn`` under ``builder`` from ``params``
    (the runner copies them), eagerly or through ``make_callable(aot=
    True)``; ``prepare(runner)`` before the state. No checks: the losses,
    host ms per step, the launches over the steps (``counts``: the flash
    kernels', or with :func:`_ring_counts` the hop wrappers' too), peak
    device memory, the runner, the state, the step and the placed batch."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    counts = counts or _flash_counts
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=builder, device=device)
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, functools.partial(torch.optim.SGD, lr=lr),
        example_batch=batch))
    if prepare is not None:
        prepare(runner)
    state = runner.create_state()
    batch = runner.remapper.shard_batch(batch)
    step = runner.make_callable(batch, aot=aot)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counts(fa, reset=True)  # this run's main path
    losses, times = [], []
    for _ in range(steps):
        (state, m), ms = _timed(torch, device, lambda: step(state, batch))
        losses.append(float(m["loss"]))
        times.append(ms)
    return types.SimpleNamespace(
        losses=losses, times=times, launches=counts(fa),
        peak=torch.cuda.max_memory_allocated() if device == "cuda" else 0,
        runner=runner, state=state, step=step, batch=batch)


def _unstacked(torch, params):
    """The stacked LM's weights in the ``layer<i>`` layout (copies)."""
    from autodist_tpu_torch.utils.tree import tree_map
    out = {k: v for k, v in params.items() if k != "blocks"}
    n = next(iter(flatten_params(params["blocks"]).values())).shape[0]
    for i in range(n):
        out[f"layer{i}"] = tree_map(lambda t: t[i].clone(), params["blocks"])
    return out


def pp_train_rank(rank, world, port, spec):
    """One rank of :func:`pipeline_phase`: a gloo world over ``localhost``
    on device 0; the stacked LM of ``spec`` trains ``spec["steps"]`` SGD
    steps under Pipeline(num_stages=world, num_microbatches=PP_MICRO) under
    each schedule of ``PP_SCHEDULES``, shift again, and shift with each
    fault of ``PP_FAULTS``; the shift run is saved through
    ``CheckpointManager`` into ``spec["ckpt"]`` and takes one step more.
    Prints {run: losses, launches, ms, mesh, schedule, update error against
    the reference and against the shift run, digests of the whole params
    and of the pieces, stored bytes, peak memory}, the shift run's logical
    digest per leaf and next loss, and the pipe hop's and the output
    broadcast's ms."""
    import datetime
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.parallel.collectives import exchange
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
        torch, spec["dtype"])))
    params, init = _lm_init(torch, cfg, device)
    tokens = sp_tokens(cfg, spec["batch"], spec["seq"])
    ref = torch.load(spec["ref"], map_location=device)

    def data_only(runner):  # whole gradients over the data group alone
        runner._grad_group = runner.program.mesh.group("data")

    def head(runner):  # every rank's backward seeded 1: the head S times
        runner._backward_seed = lambda loss: torch.ones_like(loss)

    out = {"rank": rank}
    shift = None
    for key in ("shift", "shift_again", "sequential", "1f1b") + PP_FAULTS:
        sched = key if key in PP_SCHEDULES else "shift"
        os.environ["AUTODIST_PIPELINE_SCHEDULE"] = sched
        try:
            run = _train(torch, fa, device, S.Pipeline(
                num_stages=world, num_microbatches=PP_MICRO),
                lm.make_loss_fn(cfg), params, (tokens,), spec["steps"],
                spec["lr"],
                prepare={"data_only": data_only, "head": head}.get(key))
        finally:
            del os.environ["AUTODIST_PIPELINE_SCHEDULE"]
        kinds = run.runner.var_kinds
        final = flatten_params(run.runner.logical_params(run.state))
        stored = flatten_params(run.state.params)
        blocks = [n for n in stored if n.startswith("blocks/")]
        out[key] = {
            "losses": run.losses, "launches": run.launches, "ms": run.times,
            "mesh": dict(run.runner.program.mesh.shape),
            "schedule": run.runner.program.parallel_context()
            .pipeline_schedule,
            "update_error": update_error(torch, final, ref, init),
            "vs_shift": (update_error(torch, final, shift, init)
                         if shift is not None else 0.0),
            "whole": key in PP_FAULTS or _digest(torch, (
                t for n, t in sorted(stored.items()) if kinds[n][0] != "tp")),
            "pieces": key in PP_FAULTS or _digest(torch, (
                t for n, t in sorted(stored.items()) if kinds[n][0] == "tp")),
            "piece_kinds": sorted({kinds[n][0] for n in blocks}),
            "stored_bytes": sum(t.numel() * t.element_size()
                                for t in stored.values()),
            "whole_bytes": sum(t.numel() * t.element_size()
                               for t in final.values()),
            "stored_blocks": sum(stored[n].numel() for n in blocks),
            "whole_blocks": sum(final[n].numel() for n in blocks),
            "stored_params": sum(t.numel() for t in stored.values()),
            "whole_params": sum(t.numel() for t in final.values()),
            "peak_bytes": run.peak}
        if key == "shift":
            shift = {n: t.clone() for n, t in final.items()}
            out["logical"] = {n: _digest(torch, [t]) for n, t in
                              final.items()}
            mgr = CheckpointManager(run.runner, spec["ckpt"])
            mgr.save(spec["steps"], run.state, force=True)
            mgr.wait_until_finished()
            mgr.close()
            run.state, m = run.step(run.state, run.batch)
            out["next_loss"] = float(m["loss"])
            group = run.runner.program.mesh.group("pipe")
            me = run.runner.program.mesh.axis_index("pipe")
            act = torch.zeros((spec["batch"] // PP_MICRO, spec["seq"],
                               cfg.dim), dtype=cfg.dtype, device=device)
            recv = torch.empty_like(act)
            out["hop_ms"] = _collective_ms(torch, device, lambda: exchange(
                act, recv, group, dst=1 if me == 0 else None,
                src=0 if me == 1 else None))
            outs = torch.zeros((spec["batch"], spec["seq"], cfg.dim),
                               dtype=cfg.dtype, device=device)
            out["broadcast_ms"] = _collective_ms(
                torch, device, lambda: dist.broadcast(
                    outs, src=dist.get_global_rank(group, world - 1),
                    group=group))
            out["hop_bytes"] = act.numel() * act.element_size()
        del run, final, stored
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def pipeline_phase(torch, fa, card, device, vocab=32000, dim=1024, heads=16,
                   layers=PP_LAYERS, max_len=PP_SEQ, batch=PP_BATCH,
                   steps=PP_STEPS, share=None):
    """Phase 13: (a) the stacked LM on one rank (eager, again, aot=True,
    unstacked); (b) ``PP_WORLD`` gloo ranks (processes of this script) on
    the one card under Pipeline(num_stages=PP_WORLD,
    num_microbatches=PP_MICRO) through AutoDist -> Runner.step, each rank
    its stage, held to (a) between the floor and the planted faults,
    sequential and 1f1b to shift; (c) each rank's flash launches: its
    layers x microbatches a step (twice the forward under 1f1b); (d) the
    shift run's checkpoint restored on one rank. Returns {path: flash
    launches, summed over the ranks}. ``share`` ({"dir": a directory})
    receives the one-rank reference for phase 15: ``share["reference"]``
    = (losses, (floor loss, floor update), path of the final params)."""
    import tempfile
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    t_phase = time.perf_counter()
    cfg = T.TransformerConfig(vocab=vocab, dim=dim, num_heads=heads,
                              num_layers=layers, max_len=max_len,
                              causal=True, dtype=torch.bfloat16,
                              scan_layers=True)
    seq = max_len
    tokens = sp_tokens(cfg, batch, seq)
    per_stage = layers // PP_WORLD
    print(f"phase 13: the LM at lm1b's widths (vocab {vocab}, dim {dim}, "
          f"{heads} heads, {layers} layers, scan_layers=True), batch {batch}"
          f" x {seq} tokens, SGD {PP_LR}, {steps} steps; (a) one rank, (b) "
          f"{PP_WORLD} gloo ranks on one device under Pipeline(num_stages="
          f"{PP_WORLD}, num_microbatches={PP_MICRO}) ({per_stage} layers a "
          f"rank, microbatches of {batch // PP_MICRO} x {seq})", flush=True)
    params, init = _lm_init(torch, cfg, device)
    runs = {}
    try:
        for key, aot in (("ref", False), ("again", False), ("aot", True)):
            run = _train(torch, fa, device, S.AllReduce(),
                         lm.make_loss_fn(cfg), params, (tokens,), steps,
                         PP_LR, aot=aot)
            runs[key] = types.SimpleNamespace(
                losses=run.losses, times=run.times, launches=run.launches,
                peak=run.peak, final=flatten_params(
                    run.runner.logical_params(run.state)))
            del run
        flat_cfg = copy.copy(cfg)
        flat_cfg.scan_layers = False
        run = _train(torch, fa, device, S.AllReduce(),
                     lm.make_loss_fn(flat_cfg), _unstacked(torch, params),
                     (tokens,), steps, PP_LR)
        runs["unstacked"] = types.SimpleNamespace(
            losses=run.losses, times=run.times, launches=run.launches)
        del run
    finally:
        autodist_mod._reset_default()
    ref = runs["ref"]
    floor = {"loss": _rel(runs["again"].losses, ref.losses),
             "update": update_error(torch, runs["again"].final, ref.final,
                                    init)}
    unstacked = _rel(runs["unstacked"].losses, ref.losses)
    print(f"  (a) one rank AllReduce(): losses "
          f"{', '.join(f'{x:.6f}' for x in ref.losses)}; ms per step eager "
          f"{', '.join(f'{x:.1f}' for x in ref.times)}, aot=True "
          f"{', '.join(f'{x:.1f}' for x in runs['aot'].times)}; peak "
          f"{ref.peak / 2**30:.2f} GiB; floor (the run again): loss "
          f"{floor['loss']:.3e}, update {floor['update']:.3e}; aot=True "
          f"losses bitwise: {runs['aot'].losses == ref.losses}; unstacked "
          f"max rel. diff {unstacked:.3e} (tol {PP_UNSTACKED_RTOL}); flash "
          f"launches {ref.launches}; on {card}", flush=True)
    check(all(np.isfinite(ref.losses)) and ref.losses[-1] < ref.losses[0],
          f"(a) one rank's losses {ref.losses}")
    check(runs["aot"].losses == ref.losses, f"(a) aot=True losses "
          f"{runs['aot'].losses} are not bitwise {ref.losses}")
    check(unstacked <= PP_UNSTACKED_RTOL, f"(a) the unstacked losses "
          f"{runs['unstacked'].losses} vs {ref.losses}")
    for key in ("ref", "aot", "unstacked"):
        want = {name: layers * steps for name in runs[key].launches}
        check(runs[key].launches == want, f"(a) {key}: launches "
              f"{runs[key].launches}, expected {want}")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    ref_path = os.path.join(tmp.name, "ref.pt")
    ckpt = os.path.join(tmp.name, "pp_ckpt")
    torch.save({n: t.detach().cpu() for n, t in ref.final.items()},
               ref_path)
    if share is not None:
        shutil.copy(ref_path, os.path.join(share["dir"], "pp_ref.pt"))
        share["reference"] = (ref.losses, (floor["loss"], floor["update"]),
                              os.path.join(share["dir"], "pp_ref.pt"))
    one_rank = {key: runs[key].launches for key in ("ref", "aot")}
    ref_losses = ref.losses
    del runs, ref, init  # params stay: (d)'s runner is built over them
    if device == "cuda":
        torch.cuda.empty_cache()
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = json.dumps({"device": device, "config": fields,
                       "dtype": str(cfg.dtype).split(".")[-1], "seq": seq,
                       "batch": batch, "steps": steps, "lr": PP_LR,
                       "ref": ref_path, "ckpt": ckpt})
    try:
        ranks = _spawn_ranks(PP_WORLD, "--pp-train", spec, "a pipeline rank")
        paths = {}
        r0 = ranks[0]
        want_losses = r0["shift"]["losses"]
        faults = {key: (_rel(r0[key]["losses"], ref_losses),
                        r0[key]["update_error"]) for key in PP_FAULTS}
        pp_floor = {"loss": _rel(r0["shift_again"]["losses"], want_losses),
                    "update": r0["shift_again"]["vs_shift"]}
        print(f"  (b) floors: one rank {floor['loss']:.3e} / "
              f"{floor['update']:.3e}, pipelined (shift again) "
              f"{pp_floor['loss']:.3e} / {pp_floor['update']:.3e}; planted "
              f"faults (loss / update vs one rank): " + "; ".join(
                  f"{key}: {l:.3e} / {u:.3e}" for key, (l, u) in
                  faults.items()), flush=True)
        for key in PP_SCHEDULES:
            runs_k = [r[key] for r in ranks]
            rk = runs_k[0]
            print(f"  Pipeline under '{key}' (mesh {rk['mesh']}, schedule "
                  f"{rk['schedule']}): losses "
                  f"{', '.join(f'{x:.6f}' for x in rk['losses'])}; max rel. "
                  f"diff vs one rank {_rel(rk['losses'], ref_losses):.3e} "
                  f"(tol {PP_LOSS_RTOL}); update error vs one rank "
                  f"{rk['update_error']:.3e} (tol {PP_UPDATE_RTOL}), vs shift "
                  f"{rk['vs_shift']:.3e}; whole params equal on every "
                  f"rank: {len({r['whole'] for r in runs_k}) == 1}; "
                  f"flash launches per rank {rk['launches']}", flush=True)
            for i, r in enumerate(runs_k):
                print(f"    rank {i}: stores {r['stored_params'] / 1e6:.2f} "
                      f"M of {r['whole_params'] / 1e6:.2f} M parameters "
                      f"({r['stored_bytes']} of {r['whole_bytes']} bytes, "
                      f"{100 * r['stored_bytes'] / r['whole_bytes']:.1f}%; "
                      f"blocks {r['stored_blocks']} of {r['whole_blocks']}); "
                      f"peak memory {r['peak_bytes'] / 2**30:.2f} GiB; ms "
                      f"per step (host-inclusive) "
                      f"{', '.join(f'{x:.1f}' for x in r['ms'])}; on {card}",
                      flush=True)
        print(f"  (b) the pipe hop of a {r0['hop_bytes'] / 2**20:.1f} MiB "
              f"microbatch activation through gloo ({device} tensors, "
              f"host-inclusive): {r0['hop_ms']:.2f} ms; the output "
              f"broadcast ({PP_BATCH} x {seq} x {dim} bf16) "
              f"{r0['broadcast_ms']:.2f} ms; on {card}", flush=True)
        for i, (what, tol) in enumerate((("loss", PP_LOSS_RTOL),
                                         ("update", PP_UPDATE_RTOL))):
            least = min(f[i] for f in faults.values())
            check(floor[what] < tol < least, f"(b) the {what} tolerance "
                  f"{tol} does not lie between the floor {floor[what]} and "
                  f"the faults' least reading {least}")
        for key in PP_SCHEDULES:
            runs_k = [r[key] for r in ranks]
            rk = runs_k[0]
            rel = _rel(rk["losses"], ref_losses)
            check(rel <= PP_LOSS_RTOL, f"(b) {key}: losses {rk['losses']} "
                  f"vs one rank's {ref_losses} ({rel:.3e})")
            check(rk["update_error"] <= PP_UPDATE_RTOL, f"(b) {key}: update "
                  f"error {rk['update_error']}")
            check(all(r["losses"] == rk["losses"] for r in runs_k),
                  f"(b) {key}: the ranks' losses differ")
            check(len({r["whole"] for r in runs_k}) == 1,
                  f"(b) {key}: the whole params differ across the ranks")
            check(len({r["pieces"] for r in runs_k}) == PP_WORLD,
                  f"(b) {key}: two ranks hold the same stage")
            check(all(r["mesh"] == {"data": 1, "pipe": PP_WORLD} and
                      r["schedule"] == key and r["piece_kinds"] == ["tp"]
                      for r in runs_k), f"(b) {key}: mesh {rk['mesh']}, "
                  f"schedule {rk['schedule']}, kinds {rk['piece_kinds']}")
            check(all(2 * r["stored_blocks"] == r["whole_blocks"]
                      for r in runs_k), f"(b) {key}: a rank stores "
                  f"{rk['stored_blocks']} of {rk['whole_blocks']} block "
                  f"parameters")
            fwd = per_stage * PP_MICRO * steps * (2 if key == "1f1b" else 1)
            want = {"flash_fwd": fwd,
                    "flash_bwd_dq": per_stage * PP_MICRO * steps,
                    "flash_bwd_dkv": per_stage * PP_MICRO * steps}
            for r in runs_k:
                check(r["launches"] == want, f"(c) {key}: launches "
                      f"{r['launches']}, expected {want}")
            paths[f"pp_gloo{PP_WORLD}_{key}"] = {
                k: sum(r["launches"][k] for r in runs_k) for k in want}
            if key != "shift":
                rel_shift = _rel(rk["losses"], want_losses)
                check(rel_shift <= pp_floor["loss"], f"(b) {key}: losses "
                      f"{rk['losses']} vs shift's {want_losses} "
                      f"({rel_shift:.3e}; floor {pp_floor['loss']:.3e})")
                check(rk["vs_shift"] <= pp_floor["update"],
                      f"(b) {key}: update {rk['vs_shift']:.3e} from shift's "
                      f"(floor {pp_floor['update']:.3e})")
        for key, label in (("ref", "pp_one_rank"), ("aot", "pp_one_rank_aot")):
            paths[label] = one_rank[key]

        # (d) the checkpoint restored on one rank.
        autodist_mod._reset_default()
        ad = AutoDist(strategy_builder=S.AllReduce(), device=device)
        runner = ad.create_distributed_session(ad.capture(
            lm.make_loss_fn(cfg), params,
            functools.partial(torch.optim.SGD, lr=PP_LR),
            example_batch=(tokens,)))
        del params
        state = CheckpointManager(runner, ckpt).restore_or_init()
        got = {n: _digest(torch, [t]) for n, t in
               flatten_params(runner.logical_params(state)).items()}
        check(got == r0["logical"], f"(d) the restored leaves "
              f"{sorted(n for n in got if got[n] != r0['logical'].get(n))[:5]}"
              f" are not bitwise the pipelined run's logical params")
        state, m = runner.step(state, (tokens,))
        rel = abs(float(m["loss"]) - r0["next_loss"]) / abs(r0["next_loss"])
        print(f"  (d) the 2-stage checkpoint (step {steps}) restored into a "
              f"one-rank AllReduce() Runner: {len(got)} leaves bitwise; its "
              f"next step's loss {float(m['loss']):.6f} vs the pipelined "
              f"run's {r0['next_loss']:.6f} (rel. {rel:.3e}, tol "
              f"{PP_LOSS_RTOL})", flush=True)
        check(rel <= PP_LOSS_RTOL, f"(d) restored loss {float(m['loss'])} "
              f"vs {r0['next_loss']}")
        del state, runner
    finally:
        autodist_mod._reset_default()
        tmp.cleanup()
    print(f"  (e) phase 13 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


# Phases 14 and 15: sequence parallelism composed.

def composed_hop_phase(torch, fa):
    """Phase 14 (c) / 15 (c): the hop functions at the composed rings'
    shapes (``SP_HOP_SHAPE``: BERT-base's 12 heads over a 64-row chunk,
    non-causal; ``CP_HOP_SHAPE``: the 6 heads of a TP rank over it;
    ``PPSP_HOP_SHAPE``: lm1b's 16 heads over a 512-row chunk, causal, the
    diagonal and a visible hop) against their plain versions, then timed
    beside them, SDPA and the bound. Returns {hop function: {case:
    fields}}."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    f32 = torch.float32
    out = {"block_attn_fwd": {}, "block_attn_bwd": {}}
    for case, shape, causal, (r, j) in (
            ("bert_sp", SP_HOP_SHAPE, False, (0, 1)),
            ("bert_tp_sp", CP_HOP_SHAPE, False, (0, 1)),
            ("lm1b_pp_sp_diagonal", PPSP_HOP_SHAPE, True, (1, 1)),
            ("lm1b_pp_sp_visible", PPSP_HOP_SHAPE, True, (1, 0))):
        b, h, s, d = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.bfloat16) for _ in range(4))
        args = (q, k, v, causal, r * s, j * s)
        o, lse = fa.block_attn_fwd(*args)
        ro, rl = fa.flash_fwd_reference(*args, out_dtype=f32)
        err_f = float((o - ro).abs().max())
        check(err_f <= O_F32_ATOL and float((lse - rl).abs().max()) <=
              LSE_ATOL, f"block_attn_fwd {case}: o off by {err_f}")
        delta = (do.float() * o).sum(-1, keepdim=True)
        bargs = (q, k, v, do, lse, delta, causal, r * s, j * s)
        got, want = fa.block_attn_bwd(*bargs), fa.flash_bwd_reference(*bargs)
        err_b = 0.0
        for label, g, w in zip(("dq", "dk", "dv"), got, want):
            tol = BWD_REL_DV_BF16 if label == "dv" else BWD_REL_DQDK_BF16
            err = float((g - w).abs().max())
            err_b = max(err_b, err)
            check(err <= tol * float(w.abs().max()), f"block_attn_bwd "
                  f"{case}: {label} off by {err}")
        diag = causal and r == j
        pairs = float(b * h * s * s) * ((s + 1) / (2 * s) if diag else 1.0)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        lib_out = sdpa(*leaves, is_causal=diag)
        for name, kern_fn, plain_fn, lib_fn, flops, nbytes, err in (
                ("block_attn_fwd", lambda: fa.block_attn_fwd(*args),
                 lambda: fa.flash_fwd_reference(*args, out_dtype=f32),
                 lambda: sdpa(q, k, v, is_causal=diag), 4.0 * pairs * d,
                 3 * q.numel() * 2 + q.numel() * 4 + b * h * s * 4, err_f),
                ("block_attn_bwd", lambda: fa.block_attn_bwd(*bargs),
                 lambda: fa.flash_bwd_reference(*bargs),
                 lambda: torch.autograd.grad(lib_out, leaves, do,
                                             retain_graph=True),
                 10.0 * pairs * d,
                 4 * q.numel() * 2 + 2 * b * h * s * 4 + 3 * q.numel() * 4,
                 err_b)):
            kern, plain, lib = (timed(torch, f) for f in (kern_fn, plain_fn,
                                                          lib_fn))
            bnd = bound(flops, nbytes)
            print(f"  {name} at b{b} h{h} s{s} d{d} bf16 ({case}, "
                  f"{'causal' if causal else 'non-causal'}, q chunk {r}, k "
                  f"chunk {j}): device ms per call {kern['ms']:.4f}, "
                  f"host-inclusive {kern['host_ms']:.4f}; plain "
                  f"{plain['ms']:.4f}; SDPA {lib['ms']:.4f}; bound "
                  f"{bnd[0]:.4f} ({bnd[1]}); bound / kernel "
                  f"{bnd[0] / kern['ms']:.3f}; max abs err {err:.3e}",
                  flush=True)
            out[name][case] = {
                "shape": list(shape), "causal": causal, "ms": kern["ms"],
                "host_ms": kern["host_ms"], "plain_ms": plain["ms"],
                "library_ms": lib["ms"], "bound_ms": bnd[0],
                "bound_by": bnd[1], "max_abs_err": err}
        del q, k, v, do, o, lse, ro, rl, got, want, leaves, lib_out
    return out


def cp_train_rank(rank, world, port, spec):
    """One rank of phases 14 and 15: a gloo world over ``localhost`` on
    device 0; BERT's MLM or the stacked LM (``spec``) trains each run of
    ``spec["runs"]`` ([key, builder, fault, schedule]) from the seeded
    init, with its fault monkeypatched in: ``local`` (each rank's
    attention within its own chunk), ``undivided`` (the gathered gradient
    left undivided by the model size), ``crossed`` (the pipe hop sent to
    the next stage's rank of the other chunk). Prints {run: losses,
    launches, ms, mesh, place, update error against the reference, digests
    of the whole params and of the pieces, stored and whole bytes, peak
    memory} and the groups' collective ms (after the first run)."""
    import datetime
    import importlib
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import bert, lm
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.parallel import collectives
    from autodist_tpu_torch.pipeline import schedule
    ra = importlib.import_module("autodist_tpu_torch.parallel.ring_attention")
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
        torch, spec["dtype"])))
    gen = torch.Generator().manual_seed(0)
    if spec["model"] == "bert":
        params = bert.init(cfg, gen, device=device)
        batch = tuple(torch.as_tensor(a, device=device) for a in
                      bert.synthetic_batch(cfg, spec["batch"], spec["seq"],
                                           spec["masked"], seed=0))
        loss_fn = bert.make_loss_fn(cfg)
    else:
        params = lm.init(cfg, gen, device=device)
        batch = (sp_tokens(cfg, spec["batch"], spec["seq"]).to(device),)
        loss_fn = lm.make_loss_fn(cfg)
    init = {n: t.detach().clone() for n, t in flatten_params(params).items()}
    ref = torch.load(spec["ref"], map_location=device)
    # The crossed pipe groups of {pipe: 2, seq: 2} (rank = 2 pipe + seq):
    # stage 0 of chunk c with stage 1 of chunk 1 - c.
    crossed = None
    if any(run[2] == "crossed" for run in spec["runs"]):
        crossed = [dist.new_group([0, 3]), dist.new_group([1, 2])][
            rank in (1, 2)]
    real_init = schedule._Run.__init__

    def crossed_init(self, stage_fn, treedef, num_micro, group, *rest):
        real_init(self, stage_fn, treedef, num_micro, crossed, *rest)

    def undivided(ctx, grad):
        return (collectives.reduce_scatter(grad, ctx.dim, ctx.group), None,
                None, None)
    faults = {"local": (ra, "ring_attention", lambda q, k, v, group=None,
                        causal=False: fa.flash_attention(q, k, v, causal)),
              "undivided": (collectives.GatherShards, "backward",
                            staticmethod(undivided)),
              "crossed": (schedule._Run, "__init__", crossed_init)}
    out = {"rank": rank}
    for key, builder, fault, sched in spec["runs"]:
        patch = faults.get(fault)
        if patch is not None:
            real = patch[0].__dict__[patch[1]]
            setattr(patch[0], patch[1], patch[2])
        if sched:
            os.environ["AUTODIST_PIPELINE_SCHEDULE"] = sched
        try:
            run = _train(torch, fa, device, eval(builder, {"S": S}),
                         loss_fn, params, batch, spec["steps"], spec["lr"],
                         counts=_ring_counts)
        finally:
            if patch is not None:
                setattr(patch[0], patch[1], real)
            os.environ.pop("AUTODIST_PIPELINE_SCHEDULE", None)
        kinds = run.runner.var_kinds
        final = flatten_params(run.runner.logical_params(run.state))
        stored = flatten_params(run.state.params)
        mesh = run.runner.program.mesh
        out[key] = {
            "losses": run.losses, "launches": run.launches, "ms": run.times,
            "mesh": dict(mesh.shape),
            "place": {a: mesh.axis_index(a) for a in mesh.axis_names},
            "schedule": run.runner.program.parallel_context()
            .pipeline_schedule,
            "update_error": update_error(torch, final, ref, init),
            "whole": _digest(torch, (t for n, t in sorted(stored.items())
                                     if kinds[n][0] != "tp")),
            "pieces": _digest(torch, (t for n, t in sorted(stored.items())
                                      if kinds[n][0] == "tp")),
            "stored_bytes": sum(t.numel() * t.element_size()
                                for t in stored.values()),
            "whole_bytes": sum(t.numel() * t.element_size()
                               for t in final.values()),
            "peak_bytes": run.peak}
        if "collectives" not in out:
            out["collectives"] = _cp_collectives(torch, cfg, spec, mesh,
                                                 device)
        del run, final, stored
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def _cp_collectives(torch, cfg, spec, mesh, device):
    """Host-inclusive ms of one rank's collectives on ``mesh`` (every rank
    calls them): the ring's hop of a K chunk over the seq group, the model
    group's activation all-reduce, the pipe hop of a microbatch's chunk and
    the output broadcast over the pipe group, as the mesh has them."""
    import torch.distributed as dist
    from autodist_tpu_torch.parallel.collectives import exchange
    shape, out = mesh.shape, {}
    p = shape["seq"]
    rows, chunk = spec["batch"], spec["seq"] // p
    heads = cfg.num_heads // shape.get("model", 1)
    if shape.get("pipe", 1) > 1:
        rows //= spec["micro"]
    hd = cfg.dim // cfg.num_heads
    kv = torch.zeros((rows, heads, chunk, hd), dtype=cfg.dtype, device=device)
    recv = torch.empty_like(kv)
    group, me = mesh.group("seq"), mesh.axis_index("seq")
    out["seq_hop"] = (_collective_ms(torch, device, lambda: exchange(
        kv, recv, group, dst=(me + 1) % p, src=(me - 1) % p)),
        kv.numel() * kv.element_size())
    act = torch.zeros((rows, chunk, cfg.dim), dtype=cfg.dtype, device=device)
    if shape.get("model", 1) > 1:
        group = mesh.group("model")
        out["model_all_reduce"] = (_collective_ms(
            torch, device, lambda: dist.all_reduce(act, group=group)),
            act.numel() * act.element_size())
    if shape.get("pipe", 1) > 1:
        group, me = mesh.group("pipe"), mesh.axis_index("pipe")
        recv = torch.empty_like(act)
        out["pipe_hop"] = (_collective_ms(torch, device, lambda: exchange(
            act, recv, group, dst=1 if me == 0 else None,
            src=0 if me == 1 else None)), act.numel() * act.element_size())
        outs = torch.zeros((spec["batch"], chunk, cfg.dim), dtype=cfg.dtype,
                           device=device)
        out["pipe_broadcast"] = (_collective_ms(
            torch, device, lambda: dist.broadcast(
                outs, src=dist.get_global_rank(group, 1), group=group)),
            outs.numel() * outs.element_size())
    return out


def _cp_report(card, label, runs, ref_losses, want_mesh, want_launches,
               steps, collectives=None):
    """Print one composed run of every rank and check it: its losses and
    update within the phase's tolerances of one rank (the caller passes
    them), the ranks' losses equal, whole params bitwise equal, the pieces
    equal across a seq group and different across their piece group, the
    mesh and the launches. Returns (loss reading, update reading)."""
    r0 = runs[0]
    rel = _rel(r0["losses"], ref_losses)
    err = max(r["update_error"] for r in runs)
    coll = "; ".join(f"{k} {ms:.2f} ms ({n / 2**20:.2f} MiB)"
                     for k, (ms, n) in (collectives or {}).items())
    print(f"  {label} (mesh {r0['mesh']}): losses "
          f"{', '.join(f'{x:.6f}' for x in r0['losses'])}; max rel. diff vs "
          f"one rank {rel:.3e}; largest update error over the ranks "
          f"{err:.3e}; whole params bitwise equal on every rank: "
          f"{len({r['whole'] for r in runs}) == 1}; launches per rank and "
          f"step {({k: v / steps for k, v in r0['launches'].items()})}"
          + (f"; collectives (rank 0, gloo, host-inclusive): {coll}"
             if coll else ""), flush=True)
    for i, r in enumerate(runs):
        print(f"    rank {i} {r['place']}: stores {r['stored_bytes']} of "
              f"{r['whole_bytes']} parameter bytes "
              f"({100 * r['stored_bytes'] / r['whole_bytes']:.1f}%); peak "
              f"memory {r['peak_bytes'] / 2**30:.2f} GiB; ms per step "
              f"(host-inclusive) {', '.join(f'{x:.1f}' for x in r['ms'])}; "
              f"on {card}", flush=True)
    check(all(r["losses"] == r0["losses"] for r in runs),
          f"{label}: the ranks' losses differ")
    check(len({r["whole"] for r in runs}) == 1,
          f"{label}: the whole params differ across the ranks")
    check(all(r["mesh"] == want_mesh for r in runs),
          f"{label}: mesh {r0['mesh']}, expected {want_mesh}")
    piece_axis = next((a for a in ("model", "pipe") if a in want_mesh), None)
    if piece_axis is not None:
        by = {}
        for r in runs:
            by.setdefault(r["place"][piece_axis], set()).add(r["pieces"])
        check(all(len(v) == 1 for v in by.values()) and
              len(set().union(*by.values())) == want_mesh[piece_axis],
              f"{label}: the pieces are not one per {piece_axis} index")
    for r in runs:
        check(r["launches"] == want_launches, f"{label}: launches "
              f"{r['launches']}, expected {want_launches}")
    return rel, err


def _cp_tolerances(what, floor, faults, tols):
    """Check each tolerance lies between its floor and the faults' least
    reading."""
    for i, (name, tol) in enumerate(zip(("loss", "update"), tols)):
        least = min(f[i] for f in faults.values())
        check(floor[i] < tol < least, f"{what}: the {name} tolerance {tol} "
              f"does not lie between the floor {floor[i]} and the faults' "
              f"least reading {least}")


def _hop_launches(layers, steps, hops, ring=True, forwards=1):
    """Per rank: each layer's attention a step, ``hops`` ring hops (one
    flash kernel each way a hop) or one Ulysses call."""
    calls = layers * steps * (hops if ring else 1)
    return {"flash_fwd": calls * forwards, "flash_bwd_dq": calls,
            "flash_bwd_dkv": calls,
            "block_attn_fwd": calls * forwards if ring else 0,
            "block_attn_bwd": calls if ring else 0}


def composed_bert_phase(torch, fa, card, cfg, device, batch_size=CP_BATCH,
                        seq=CP_SEQ, num_masked=CP_MASKED, steps=CP_STEPS):
    """Phase 14: BERT's MLM under a seq axis. One rank's AllReduce() steps
    and again (the floor); (a) two gloo ranks under SequenceParallel
    ("ring") on {data: 1, seq: 2}; (b) four under ModelParallel(
    SequenceParallel(ring | ulysses, 2), 2) on {data: 1, seq: 2, model:
    2}; each held to one rank between the floor and the planted faults.
    Returns {path: launches, summed over the ranks}."""
    import tempfile
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.ops import build
    t_phase = time.perf_counter()
    print(f"phase 14: BERT's MLM under a seq axis, BERT at width {cfg.dim}, "
          f"{cfg.num_heads} heads, {cfg.num_layers} layers (vocab "
          f"{cfg.vocab}, max_len {cfg.max_len}; batch {batch_size} x {seq}, "
          f"{num_masked} masked positions a row, SGD {CP_LR}), {steps} eager "
          f"steps vs one rank's AllReduce()", flush=True)
    batch = bert.synthetic_batch(cfg, batch_size, seq, num_masked, seed=0)
    counts = ((batch[2] >= 0) & (batch[2] < seq // 2)).sum(1)
    print(f"  masked positions a row in the first half of the sequence: "
          f"{counts.tolist()} (of {num_masked})", flush=True)
    try:
        ref = strategy_run(torch, fa, cfg, device, "one rank AllReduce()",
                           S.AllReduce(), batch, steps, optimizer="SGD",
                           lr=CP_LR)
        again = strategy_run(torch, fa, cfg, device,
                             "one rank AllReduce() again", S.AllReduce(),
                             batch, steps, optimizer="SGD", lr=CP_LR)
    finally:
        autodist_mod._reset_default()
    floor = (_rel(again.losses, ref.losses),
             update_error(torch, again.params, ref.params, ref.init))
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    ref_path = os.path.join(tmp.name, "ref.pt")
    torch.save({n: t.detach().cpu() for n, t in ref.params.items()},
               ref_path)
    ref_losses = ref.losses
    print(f"  one rank AllReduce(): losses "
          f"{', '.join(f'{x:.6f}' for x in ref_losses)}, ms per step "
          f"{', '.join(f'{x:.1f}' for x in ref.times)}; floor (the run "
          f"again): loss {floor[0]:.3e}, update {floor[1]:.3e}", flush=True)
    del ref, again
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    base = {"device": device, "config": fields, "model": "bert",
            "dtype": str(cfg.dtype).split(".")[-1], "seq": seq,
            "batch": batch_size, "masked": num_masked, "steps": steps,
            "lr": CP_LR, "ref": ref_path}
    sp = "S.SequenceParallel('ring', 2)"
    tp_sp = "S.ModelParallel(S.SequenceParallel('{}', 2), model_axis=2)"
    subs = (
        ("(a)", 2, [["ring", sp, None, None]] +
         [[f, sp, f, None] for f in CP_SP_FAULTS],
         {"data": 1, "seq": 2}, (("ring", "SequenceParallel('ring')"),)),
        ("(b)", 4, [["ring", tp_sp.format("ring"), None, None],
                    ["ulysses", tp_sp.format("ulysses"), None, None]] +
         [[f, tp_sp.format("ring"), f, None] for f in CP_TP_FAULTS],
         {"data": 1, "seq": 2, "model": 2},
         (("ring", "ModelParallel(SequenceParallel('ring', 2), 2)"),
          ("ulysses", "ModelParallel(SequenceParallel('ulysses', 2), 2)"))))
    paths = {}
    try:
        for sub, world, runs, mesh, keys in subs:
            ranks = _spawn_ranks(world, "--cp-train", json.dumps(
                dict(base, runs=runs)), f"a phase 14 {sub} rank")
            faults = {f: (_rel(ranks[0][f]["losses"], ref_losses),
                          max(r[f]["update_error"] for r in ranks))
                      for _, _, f, _ in runs if f}
            print(f"  {sub} {world} gloo ranks on one device; planted faults "
                  f"(loss / update vs one rank): " + "; ".join(
                      f"{k}: {l:.3e} / {u:.3e}" for k, (l, u) in
                      faults.items()) + f" (on {card})", flush=True)
            _cp_tolerances(f"phase 14 {sub}", floor, faults,
                           (CP_LOSS_RTOL, CP_UPDATE_RTOL))
            for key, label in keys:
                want = _hop_launches(cfg.num_layers, steps, 2,
                                     ring=key == "ring")
                rel, err = _cp_report(card, f"{sub} {label}",
                                      [r[key] for r in ranks], ref_losses,
                                      mesh, want, steps,
                                      ranks[0]["collectives"]
                                      if key == "ring" else None)
                check(rel <= CP_LOSS_RTOL, f"phase 14 {sub} {label}: loss "
                      f"{rel:.3e} (tolerance {CP_LOSS_RTOL})")
                check(err <= CP_UPDATE_RTOL, f"phase 14 {sub} {label}: "
                      f"update {err:.3e} (tolerance {CP_UPDATE_RTOL})")
                tag = "sp" if world == 2 else "tp_sp"
                paths[f"bert_{tag}_gloo{world}_{key}"] = {
                    k: sum(r[key]["launches"][k] for r in ranks)
                    for k in want}
    finally:
        tmp.cleanup()
    print(f"  (d) phase 14 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def composed_pipeline_phase(torch, fa, card, device, reference,
                            vocab=32000, dim=1024, heads=16,
                            layers=PP_LAYERS, max_len=PP_SEQ,
                            batch=PP_BATCH, steps=PP_STEPS):
    """Phase 15: the stacked LM under SequenceParallel("ring", 2, base=
    Pipeline(2, PP_MICRO)) on four gloo ranks, {data: 1, pipe: 2, seq: 2},
    under each schedule of ``PPSP_SCHEDULES`` and with the planted fault;
    held to one rank's steps (``reference``: phase 13's (losses, floor,
    path of the final params), from :func:`pipeline_phase`'s ``share``).
    Returns {path: launches, summed over the ranks}."""
    from autodist_tpu_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = T.TransformerConfig(vocab=vocab, dim=dim, num_heads=heads,
                              num_layers=layers, max_len=max_len,
                              causal=True, dtype=torch.bfloat16,
                              scan_layers=True)
    seq = max_len
    print(f"phase 15: the LM at lm1b's widths (vocab {vocab}, dim {dim}, "
          f"{heads} heads, {layers} layers, scan_layers=True), batch {batch}"
          f" x {seq}, SGD {PP_LR}, {steps} steps, on 4 gloo ranks of one "
          f"device under SequenceParallel('ring', 2, base=Pipeline(2, "
          f"{PP_MICRO})): {layers // 2} layers and a {seq // 2}-row chunk a "
          f"rank", flush=True)
    ref_losses, floor, ref_path = reference
    print(f"  one rank AllReduce() (phase 13's (a)): losses "
          f"{', '.join(f'{x:.6f}' for x in ref_losses)}; floor loss "
          f"{floor[0]:.3e}, update {floor[1]:.3e}", flush=True)
    builder = (f"S.SequenceParallel('ring', 2, base=S.Pipeline("
               f"num_stages=2, num_microbatches={PP_MICRO}))")
    runs = [[s, builder, None, s] for s in PPSP_SCHEDULES] + \
        [[f, builder, f, "shift"] for f in PPSP_FAULTS]
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = {"device": device, "config": fields, "model": "lm",
            "dtype": "bfloat16", "seq": seq, "batch": batch,
            "micro": PP_MICRO, "steps": steps, "lr": PP_LR,
            "ref": ref_path, "runs": runs}
    ranks = _spawn_ranks(4, "--cp-train", json.dumps(spec),
                         "a phase 15 rank")
    faults = {f: (_rel(ranks[0][f]["losses"], ref_losses),
                  max(r[f]["update_error"] for r in ranks))
              for f in PPSP_FAULTS}
    print(f"  (a) planted fault (loss / update vs one rank): " + "; ".join(
        f"{k}: {l:.3e} / {u:.3e}" for k, (l, u) in faults.items()) +
        f" (on {card})", flush=True)
    _cp_tolerances("phase 15", floor, faults,
                   (PPSP_LOSS_RTOL, PPSP_UPDATE_RTOL))
    mesh = {"data": 1, "pipe": 2, "seq": 2}
    paths = {}
    per_stage = layers // 2
    for sched in PPSP_SCHEDULES:
        runs = [r[sched] for r in ranks]
        want = _hop_launches(per_stage * PP_MICRO, steps, 2,
                             forwards=2 if sched == "1f1b" else 1)
        rel, err = _cp_report(card, f"(a) '{sched}'", runs, ref_losses, mesh,
                              want, steps, ranks[0]["collectives"]
                              if sched == "shift" else None)
        check(all(r["schedule"] == sched for r in runs),
              f"phase 15: schedule {runs[0]['schedule']}, not {sched}")
        check(rel <= PPSP_LOSS_RTOL, f"phase 15 {sched}: loss {rel:.3e} "
              f"(tolerance {PPSP_LOSS_RTOL})")
        check(err <= PPSP_UPDATE_RTOL, f"phase 15 {sched}: update {err:.3e} "
              f"(tolerance {PPSP_UPDATE_RTOL})")
        if sched != "shift":
            shift = [r["shift"] for r in ranks]
            check(all(a["losses"] == b["losses"] and a["whole"] == b["whole"]
                      and a["pieces"] == b["pieces"]
                      for a, b in zip(runs, shift)),
                  f"phase 15: '{sched}' is not bitwise 'shift'")
        paths[f"pp_sp_gloo4_{sched}"] = {
            k: sum(r["launches"][k] for r in runs) for k in want}
    print(f"  (b) '{PPSP_SCHEDULES[1]}' bitwise 'shift' (losses, whole "
          f"params and stages); phase 15 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths



# Phase 17: one variable split over two mesh axes. Neither the port's
# builders nor the JAX package's compose such a split (a builder's rules
# replace a node's partitioner), so the phase runs it from a fixed builder,
# :class:`TwoAxis`, as tests/test_torch_two_axis.py does. (a) Phase 13's LM
# (lm1b at PP_LAYERS, stacked, bf16) and batch on four gloo ranks under
# Pipeline(2, PP_MICRO) with every stacked Megatron weight also split over
# model on its rule's dim + 1 and the embedding on its hidden dim
# ({data: 1, pipe: 2, model: 2}: PP_LAYERS / 2 layers, 8 heads and 2048
# MLP columns a rank), under shift and 1f1b, and shift with each fault of PPTP_FAULTS
# (the copy-to-model backward without its all-reduce; the gradients that
# pipe does not split averaged over the pipe group instead of summed):
# held to phase 13's one-rank steps at PPTP_LOSS_RTOL / PPTP_UPDATE_RTOL,
# each between the one-rank floor and the faults' least reading, 1f1b
# bitwise shift. (b) Phase 12's MoE layer with up split
# "0:2:expert,2:2:model" and down "0:2:expert,1:2:model" ({data: 1,
# expert: 2, model: 2}: 4 experts x 1536 columns a rank), held to phase
# 12's one-rank steps at EPTP_LOSS_RTOL / EPTP_UPDATE_RTOL (each param's
# update) between the floor and the fault of EPTP_FAULTS (the partial
# output summed over the expert group alone). A rank's partial expert
# products are rounded to bf16 before the f32 sum over the model group,
# where one rank rounds the whole product once, hence EP x TP's own
# tolerances. Read on an H100 80GB HBM3 (700 W): floors 0 / 0 (both
# one-rank steps bitwise repeatable); (a) 4.5e-6 (loss) / 7.7e-3 (update),
# faults no_copy 7.9e-3 / 0.76, pipe_mean 2.4e-3 / 0.31; (b) 8.4e-6 /
# 1.4e-3 (the up kernel), fault 7.7e-3 / 0.50.
PPTP_SCHEDULES = ("shift", "1f1b")
PPTP_FAULTS = ("no_copy", "pipe_mean")
PPTP_LOSS_RTOL, PPTP_UPDATE_RTOL = 1e-4, 5e-2
EPTP_FAULTS = ("expert_only",)
EPTP_LOSS_RTOL, EPTP_UPDATE_RTOL = 1e-4, 1e-2
# (a)'s attention on a rank: a microbatch of PP_BATCH / PP_MICRO rows, 8 of
# lm1b's 16 heads, causal over PP_SEQ.
PPTP_SHAPE = (PP_BATCH // PP_MICRO, 8, PP_SEQ, PP_SEQ, 64)
# The stacked Megatron weights over model on their rule's dim + 1 (dim 0
# holds the layers) and the embedding on its hidden dim; each expert's FFN
# over model on up's hidden columns and down's rows.
PPTP_RULES = (
    (r"attn/(query|key|value)/kernel$", 2),
    (r"attn/(query|key|value)/bias$", 1), (r"attn/out/kernel$", 1),
    (r"mlp/up/kernel$", 2), (r"mlp/up/bias$", 1), (r"mlp/down/kernel$", 1),
    (r"embed/embedding$", 1))
EPTP_RULES = ((r"moe/up/kernel$", 2), (r"moe/down/kernel$", 1))


class TwoAxis:
    """A fixed strategy builder: ``base``'s strategy with the mesh axis
    ``axis`` of ``size`` carved out of ``data``, and each variable that a
    rule of ``rules`` ((regex, dim), the first match deciding) names also
    split over it on that dim: its partitioner gains the entry
    "dim:size:axis" after its own, automap's composed form."""

    def __init__(self, base, axis, size, rules):
        self.base, self.axis, self.size, self.rules = base, axis, size, rules

    def build(self, item, spec):
        from autodist_tpu_torch.strategy.base import carve_mesh_axis
        s = self.base.build(item, spec)
        carve_mesh_axis(s, spec, self.axis, self.size)
        for node in s.node_config:
            for pat, dim in self.rules:
                if re.search(pat, node.var_name):
                    entry = f"{dim}:{self.size}:{self.axis}"
                    node.partitioner = (f"{node.partitioner},{entry}"
                                        if node.partitioner else entry)
                    break
        return s


def pp_tp_builder(S, micro=PP_MICRO):
    """Pipeline(2, ``micro``) with the stacked Megatron weights split over
    model too: {data, pipe: 2, model: 2}."""
    return TwoAxis(S.Pipeline(num_stages=2, num_microbatches=micro),
                   "model", 2, PPTP_RULES)


def ep_tp_builder(S, moe):
    """ModelParallel over expert with each expert's FFN split over model
    too: {data, expert: 2, model: 2}."""
    return TwoAxis(S.ModelParallel(S.AllReduce(), model_axis=2,
                                   rules=moe.EXPERT_RULES,
                                   mesh_axis="expert"),
                   "model", 2, EPTP_RULES)


def ta_train_rank(rank, world, port, spec):
    """One rank of :func:`two_axis_phase`: a gloo world over ``localhost``
    on device 0; the stacked LM (``spec["model"] == "lm"``) under
    :func:`pp_tp_builder` or the MoE model under :func:`ep_tp_builder`
    trains each run of ``spec["runs"]`` ([key, fault, schedule]) from the
    seeded init, with its fault patched in. Prints {run: losses, launches,
    ms, mesh, place, schedule, update error against the reference (the
    LM's whole update; each MoE param's), digests of the whole params, of
    the pieces and of the pipe-only pieces, stored and whole bytes, peak
    memory, (MoE) step 1's expert bmms' weight shapes}, the first run's
    logical digest per leaf and next loss (the LM's, after its checkpoint
    is saved into ``spec["ckpt"]``), and the groups' collective ms."""
    import datetime
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import layers, lm
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.parallel import context, moe
    from autodist_tpu_torch.parallel.collectives import exchange
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    is_lm = spec["model"] == "lm"
    if is_lm:
        cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
            torch, spec["dtype"])))
        params, init = _lm_init(torch, cfg, device)
        batch = (sp_tokens(cfg, spec["batch"], spec["seq"]).to(device),)
        builder = pp_tp_builder(S, spec["micro"])
    else:
        cfg = ep_config(torch, **spec["config"])
        params = ep_init(torch, cfg, device)
        init = {n: t.detach().clone()
                for n, t in flatten_params(params).items()}
        batch = ep_batch(torch, cfg, spec["batch"], spec["seq"], device)
        builder = ep_tp_builder(S, moe)
    ref = torch.load(spec["ref"], map_location=device)
    patches = {"no_copy": (layers._CopyToModel, "backward", staticmethod(
                   lambda ctx, grad: (grad, None))),
               "expert_only": (context.ParallelContext, "group_over",
                               lambda self, axes: self.expert_group)}
    prepares = {"pipe_mean": lambda r: setattr(r, "_pipe_sum",
                                               lambda name: 1)}
    out = {"rank": rank}
    for key, fault, sched in spec["runs"]:
        patch = patches.get(fault)
        if patch is not None:
            real = patch[0].__dict__[patch[1]]
            setattr(patch[0], patch[1], patch[2])
        os.environ["AUTODIST_PIPELINE_SCHEDULE"] = sched
        try:
            if is_lm:
                run = _train(torch, fa, device, builder, lm.make_loss_fn(cfg),
                             params, batch, spec["steps"], spec["lr"],
                             prepare=prepares.get(fault))
            else:
                run = _ep_train(torch, fa, cfg, device, builder, params,
                                batch, spec["steps"], record=True)
        finally:
            if patch is not None:
                setattr(patch[0], patch[1], real)
            del os.environ["AUTODIST_PIPELINE_SCHEDULE"]
        runner = run.runner
        kinds = runner.var_kinds
        final = flatten_params(runner.logical_params(run.state))
        stored = flatten_params(run.state.params)
        mesh = runner.program.mesh
        dims = runner.program.piece_dims()
        out[key] = {
            "losses": run.losses, "launches": run.launches, "ms": run.times,
            "mesh": dict(mesh.shape),
            "place": {a: mesh.axis_index(a) for a in mesh.axis_names},
            "schedule": runner.program.parallel_context().pipeline_schedule,
            "update_error": update_error(torch, final, ref, init) if is_lm
            else max(update_errors(torch, final, ref, init).values()),
            "whole": _digest(torch, (t for n, t in sorted(stored.items())
                                     if n not in dims)),
            "pieces": _digest(torch, (t for n, t in sorted(stored.items())
                                      if n in dims)),
            "one_axis": {a: _digest(torch, (
                t for n, t in sorted(stored.items())
                if tuple(x for x, _ in dims.get(n, ())) == (a,)))
                for a in runner.program.piece_axes if any(
                    tuple(x for x, _ in p) == (a,) for p in dims.values())},
            "two_axes": sorted(n for n, p in dims.items() if len(p) == 2),
            "stored_bytes": sum(t.numel() * t.element_size()
                                for t in stored.values()),
            "whole_bytes": sum(t.numel() * t.element_size()
                               for t in final.values()),
            "peak_bytes": run.peak,
            "bmm": [] if is_lm else run.shapes}
        if "logical" not in out:
            out["logical"] = {n: _digest(torch, [t]) for n, t in
                              final.items()}
            if is_lm:
                mgr = CheckpointManager(runner, spec["ckpt"])
                mgr.save(spec["steps"], run.state, force=True)
                mgr.wait_until_finished()
                mgr.close()
                run.state, m = run.step(run.state, run.batch)
            else:
                _, m = run.step_fn(run.state, runner.remapper.shard_batch(
                    batch))
            out["next_loss"] = float(m["loss"])
            out["collectives"] = _ta_collectives(torch, dist, exchange, cfg,
                                                 spec, mesh, device, is_lm)
        del run, runner, final, stored
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def _ta_collectives(torch, dist, exchange, cfg, spec, mesh, device, is_lm):
    """Host-inclusive ms and bytes of one rank's collectives on ``mesh``
    (every rank calls them): the LM's model all-reduce of a microbatch's
    activation, pipe hop of it and output broadcast; the MoE's all-reduce
    of the (T, d) f32 partial output over the expert x model group."""
    out = {}
    if not is_lm:
        part = torch.zeros((spec["batch"] * spec["seq"], cfg.d_model),
                           device=device)
        group = mesh.group_over(("expert", "model"))
        out["expert_model_all_reduce"] = (_collective_ms(
            torch, device, lambda: dist.all_reduce(part, group=group)),
            part.numel() * part.element_size())
        return out
    act = torch.zeros((spec["batch"] // spec["micro"], spec["seq"], cfg.dim),
                      dtype=cfg.dtype, device=device)
    group = mesh.group("model")
    out["model_all_reduce"] = (_collective_ms(
        torch, device, lambda: dist.all_reduce(act, group=group)),
        act.numel() * act.element_size())
    group, me = mesh.group("pipe"), mesh.axis_index("pipe")
    recv = torch.empty_like(act)
    out["pipe_hop"] = (_collective_ms(torch, device, lambda: exchange(
        act, recv, group, dst=1 if me == 0 else None,
        src=0 if me == 1 else None)), act.numel() * act.element_size())
    outs = torch.zeros((spec["batch"], spec["seq"], cfg.dim),
                       dtype=cfg.dtype, device=device)
    out["pipe_broadcast"] = (_collective_ms(
        torch, device, lambda: dist.broadcast(
            outs, src=dist.get_global_rank(group, 1), group=group)),
        outs.numel() * outs.element_size())
    return out


def _ta_report(card, label, runs, ref_losses, want_mesh, steps):
    """Print one two-axis run of every rank and check what every such run
    must show: the ranks' losses equal, the whole params bitwise equal,
    the pieces one per rank, each one-axis piece equal across the ranks
    that hold it, the mesh. Returns (loss reading, update reading)."""
    r0 = runs[0]
    rel = _rel(r0["losses"], ref_losses)
    err = max(r["update_error"] for r in runs)
    print(f"  {label} (mesh {r0['mesh']}): losses "
          f"{', '.join(f'{x:.6f}' for x in r0['losses'])}; max rel. diff vs "
          f"one rank {rel:.3e}; largest update error over the ranks "
          f"{err:.3e}; whole params bitwise equal on every rank: "
          f"{len({r['whole'] for r in runs}) == 1}; leaves split over two "
          f"axes {len(r0['two_axes'])}; launches per rank and step "
          f"{({k: v / steps for k, v in r0['launches'].items()})}",
          flush=True)
    for i, r in enumerate(runs):
        print(f"    rank {i} {r['place']}: stores {r['stored_bytes']} of "
              f"{r['whole_bytes']} parameter bytes "
              f"({100 * r['stored_bytes'] / r['whole_bytes']:.1f}%); peak "
              f"memory {r['peak_bytes'] / 2**30:.2f} GiB; ms per step "
              f"(host-inclusive) {', '.join(f'{x:.1f}' for x in r['ms'])}; "
              f"on {card}", flush=True)
    check(all(r["losses"] == r0["losses"] for r in runs),
          f"{label}: the ranks' losses differ")
    check(len({r["whole"] for r in runs}) == 1,
          f"{label}: the whole params differ across the ranks")
    check(len({r["pieces"] for r in runs}) == len(runs),
          f"{label}: two ranks hold the same pieces")
    check(all(r["mesh"] == want_mesh for r in runs),
          f"{label}: mesh {r0['mesh']}, expected {want_mesh}")
    check(r0["two_axes"] and all(r["two_axes"] == r0["two_axes"]
                                 for r in runs),
          f"{label}: leaves split over two axes {r0['two_axes']}")
    for axis in r0["one_axis"]:
        # A leaf split over this axis alone: one copy a place on it.
        by = {}
        for r in runs:
            by.setdefault(r["place"][axis], set()).add(r["one_axis"][axis])
        check(all(len(v) == 1 for v in by.values()) and
              len(set().union(*by.values())) == want_mesh[axis],
              f"{label}: the leaves split over {axis} alone are not one "
              f"copy a {axis} index")
    return rel, err


def two_axis_phase(torch, fa, card, device, pp_reference, ep_reference,
                   vocab=32000, dim=1024, heads=16, layers=PP_LAYERS,
                   max_len=PP_SEQ, batch=PP_BATCH, steps=PP_STEPS,
                   ep_widths=None, ep_batch_size=EP_BATCH, ep_seq=EP_SEQ,
                   ep_steps=EP_STEPS):
    """Phase 17: (a) the stacked LM under :func:`pp_tp_builder` on four
    gloo ranks of the card, held to phase 13's one-rank steps
    (``pp_reference``: (losses, (floor loss, floor update), path of the
    final params)), its checkpoint restored on one rank ((d)); (b) the MoE
    model under :func:`ep_tp_builder` on four, held to phase 12's
    (``ep_reference``, the same form); (c) the flash kernels at (a)'s rank
    shape. Returns ({path: launches, summed over the ranks}, (c)'s fields
    by kernel)."""
    import tempfile
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    t_phase = time.perf_counter()
    cfg = T.TransformerConfig(vocab=vocab, dim=dim, num_heads=heads,
                              num_layers=layers, max_len=max_len,
                              causal=True, dtype=torch.bfloat16,
                              scan_layers=True)
    seq, per_stage = max_len, layers // 2
    print(f"phase 17: one variable split over two mesh axes; (a) the LM at "
          f"lm1b's widths (vocab {vocab}, dim {dim}, {heads} heads, {layers} "
          f"layers, scan_layers=True), batch {batch} x {seq}, SGD {PP_LR}, "
          f"{steps} steps, on 4 gloo ranks of one device under Pipeline(2, "
          f"{PP_MICRO}) with the stacked Megatron weights split over model "
          f"too (TwoAxis): {per_stage} layers, {heads // 2} heads and "
          f"{cfg.mlp_dim // 2} MLP columns a rank", flush=True)
    ref_losses, floor, ref_path = pp_reference
    print(f"  one rank AllReduce() (phase 13's (a)): losses "
          f"{', '.join(f'{x:.6f}' for x in ref_losses)}; floor loss "
          f"{floor[0]:.3e}, update {floor[1]:.3e}", flush=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    ckpt = os.path.join(tmp.name, "pp_tp_ckpt")
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    runs = [[s, None, s] for s in PPTP_SCHEDULES] + \
        [[f, f, "shift"] for f in PPTP_FAULTS]
    spec = {"device": device, "model": "lm", "config": fields,
            "dtype": "bfloat16", "seq": seq, "batch": batch,
            "micro": PP_MICRO, "steps": steps, "lr": PP_LR, "ref": ref_path,
            "ckpt": ckpt, "runs": runs}
    paths = {}
    try:
        ranks = _spawn_ranks(4, "--ta-train", json.dumps(spec),
                             "a phase 17 (a) rank")
        faults = {f: (_rel(ranks[0][f]["losses"], ref_losses),
                      max(r[f]["update_error"] for r in ranks))
                  for f in PPTP_FAULTS}
        print(f"  (a) planted faults (loss / update vs one rank): " +
              "; ".join(f"{k}: {l:.3e} / {u:.3e}" for k, (l, u) in
                        faults.items()) + f" (on {card})", flush=True)
        _cp_tolerances("phase 17 (a)", floor, faults,
                       (PPTP_LOSS_RTOL, PPTP_UPDATE_RTOL))
        mesh = {"data": 1, "pipe": 2, "model": 2}
        coll = ranks[0]["collectives"]
        print("  (a) collectives (rank 0, gloo, host-inclusive): " + "; ".join(
            f"{k} {ms:.2f} ms ({n / 2**20:.2f} MiB)" for k, (ms, n) in
            coll.items()) + f"; on {card}", flush=True)
        for sched in PPTP_SCHEDULES:
            runs_k = [r[sched] for r in ranks]
            rel, err = _ta_report(card, f"(a) '{sched}'", runs_k, ref_losses,
                                  mesh, steps)
            check(all(r["schedule"] == sched for r in runs_k),
                  f"phase 17 (a): schedule {runs_k[0]['schedule']}")
            check(rel <= PPTP_LOSS_RTOL, f"phase 17 (a) {sched}: loss "
                  f"{rel:.3e} (tolerance {PPTP_LOSS_RTOL})")
            check(err <= PPTP_UPDATE_RTOL, f"phase 17 (a) {sched}: update "
                  f"{err:.3e} (tolerance {PPTP_UPDATE_RTOL})")
            calls = per_stage * PP_MICRO * steps
            want = {"flash_fwd": calls * (2 if sched == "1f1b" else 1),
                    "flash_bwd_dq": calls, "flash_bwd_dkv": calls}
            for r in runs_k:
                check(r["launches"] == want, f"phase 17 (a) {sched}: "
                      f"launches {r['launches']}, expected {want}")
            if sched != "shift":
                shift = [r["shift"] for r in ranks]
                check(all(a["losses"] == b["losses"] and
                          a["whole"] == b["whole"] and
                          a["pieces"] == b["pieces"]
                          for a, b in zip(runs_k, shift)),
                      f"phase 17 (a): '{sched}' is not bitwise 'shift'")
            paths[f"pp_tp_gloo4_{sched}"] = {
                k: sum(r["launches"][k] for r in runs_k) for k in want}
        print(f"  (a) '{PPTP_SCHEDULES[1]}' bitwise 'shift' (losses, whole "
              f"params and pieces)", flush=True)

        # (b) the MoE layer on {expert: 2, model: 2}.
        ep_cfg = ep_config(torch, **(ep_widths or {}))
        ep_losses, ep_floor, ep_path = ep_reference
        print(f"  (b) phase 12's MoE layer (d_model {ep_cfg.d_model}, d_ff "
              f"{ep_cfg.d_hidden}, {ep_cfg.num_experts} experts) on 4 gloo "
              f"ranks of one device under ModelParallel(AllReduce(), 2, "
              f"EXPERT_RULES, mesh_axis='expert') with each expert's FFN "
              f"split over model too (TwoAxis): "
              f"{ep_cfg.num_experts // 2} experts x {ep_cfg.d_hidden // 2} "
              f"columns a rank; one rank (phase 12's (a)): losses "
              f"{', '.join(f'{x:.6f}' for x in ep_losses)}, floor loss "
              f"{ep_floor[0]:.3e}, update {ep_floor[1]:.3e}", flush=True)
        spec = {"device": device, "model": "moe", "config": ep_widths or {},
                "seq": ep_seq, "batch": ep_batch_size, "steps": ep_steps,
                "lr": EP_LR, "ref": ep_path,
                "runs": [["ep_tp", None, "shift"]] +
                [[f, f, "shift"] for f in EPTP_FAULTS]}
        ep_ranks = _spawn_ranks(4, "--ta-train", json.dumps(spec),
                                "a phase 17 (b) rank")
        faults = {f: (_rel(ep_ranks[0][f]["losses"], ep_losses),
                      max(r[f]["update_error"] for r in ep_ranks))
                  for f in EPTP_FAULTS}
        print(f"  (b) planted fault (loss / update vs one rank): " +
              "; ".join(f"{k}: {l:.3e} / {u:.3e}" for k, (l, u) in
                        faults.items()) + f" (on {card})", flush=True)
        _cp_tolerances("phase 17 (b)", ep_floor, faults,
                       (EPTP_LOSS_RTOL, EPTP_UPDATE_RTOL))
        runs_b = [r["ep_tp"] for r in ep_ranks]
        rel, err = _ta_report(card, "(b) EP x TP", runs_b, ep_losses,
                              {"data": 1, "expert": 2, "model": 2},
                              ep_steps)
        check(rel <= EPTP_LOSS_RTOL, f"phase 17 (b): loss {rel:.3e} "
              f"(tolerance {EPTP_LOSS_RTOL})")
        check(err <= EPTP_UPDATE_RTOL, f"phase 17 (b): update {err:.3e} "
              f"(tolerance {EPTP_UPDATE_RTOL})")
        local = [ep_cfg.num_experts // 2, ep_cfg.d_model,
                 ep_cfg.d_hidden // 2]
        for r in runs_b:
            check(r["bmm"] and r["bmm"][0] == local, f"phase 17 (b): step "
                  f"1's up product on {r['bmm']}, expected {local}")
            check(not any(r["launches"].values()), f"phase 17 (b): flash "
                  f"launches {r['launches']} on a path with none")
        print(f"  (b) step 1's expert products on {runs_b[0]['bmm'][:2]} "
              f"weights a rank; collectives (rank 0, gloo, "
              f"host-inclusive): " + "; ".join(
                  f"{k} {ms:.2f} ms ({n / 2**20:.2f} MiB)" for k, (ms, n) in
                  ep_ranks[0]["collectives"].items()) + f"; on {card}",
              flush=True)
        if device == "cuda":
            ep_ffn_timing(torch, card, ep_cfg, ep_batch_size * ep_seq, 2,
                          model=2)
        paths["ep_tp_gloo4"] = {k: sum(r["launches"][k] for r in runs_b)
                                for k in runs_b[0]["launches"]}

        # (d) (a)'s checkpoint restored on one rank.
        autodist_mod._reset_default()
        params, _ = _lm_init(torch, cfg, device)
        tokens = sp_tokens(cfg, batch, seq)
        ad = AutoDist(strategy_builder=S.AllReduce(), device=device)
        runner = ad.create_distributed_session(ad.capture(
            lm.make_loss_fn(cfg), params,
            functools.partial(torch.optim.SGD, lr=PP_LR),
            example_batch=(tokens,)))
        del params
        state = CheckpointManager(runner, ckpt).restore_or_init()
        got = {n: _digest(torch, [t]) for n, t in
               flatten_params(runner.logical_params(state)).items()}
        r0 = ranks[0]
        check(got == r0["logical"], f"(d) the restored leaves "
              f"{sorted(n for n in got if got[n] != r0['logical'].get(n))[:5]}"
              f" are not bitwise the two-axis run's logical params")
        state, m = runner.step(state, (tokens,))
        rel = abs(float(m["loss"]) - r0["next_loss"]) / abs(r0["next_loss"])
        print(f"  (d) the {{pipe: 2, model: 2}} checkpoint (step {steps}) "
              f"restored into a one-rank AllReduce() Runner: {len(got)} "
              f"leaves bitwise; its next step's loss {float(m['loss']):.6f} "
              f"vs the two-axis run's {r0['next_loss']:.6f} (rel. {rel:.3e}, "
              f"tol {PPTP_LOSS_RTOL})", flush=True)
        check(rel <= PPTP_LOSS_RTOL, f"(d) restored loss {float(m['loss'])} "
              f"vs {r0['next_loss']}")
        del state, runner
    finally:
        autodist_mod._reset_default()
        tmp.cleanup()
    kernels = {}
    if device == "cuda":
        kernels = tp_kernel_phase(
            torch, fa, shape=PPTP_SHAPE, key="pp_tp", label="phase 17 (c)",
            who="a PP x TP rank's 8 heads, causal", causal=True)
    print(f"  (e) phase 17 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths, kernels


# -- phase 18: the input pipeline ---------------------------------------------
#
# (a) BERT-base MLM (batch 32 x 128, 20 masked positions packed into one
# int32 record of 2 x 128 + 2 x 20 values, Adam 1e-4) for LOADER_STEPS steps
# of Runner.run(..., unroll=4) fed by a NativeDataLoader (the wired path:
# BlockStacker -> DevicePrefetcher(shard_block) -> the megastep graph) and
# by a plain iterator over a second loader of the same seed (the host
# _next_block path): step 1 bitwise, every loss within GRAPH_LOSS_RTOL (the
# MLM gather's and the embedding's scatter-add atomics part the two
# trajectories, as they part phase 7's). (b) ResNet-50 from uint8 records
# (LOADER_IMAGE_BATCHES x 64 distinct 224^2 images, normalized on the card
# in the loss), bench.py's four windows of LOADER_WINDOW transfers / steps.
# (c) LOADER_CHECKED batches of (b) with the loader's async ring on and
# depth 3, each copy held back LOADER_COPY_DELAY_MS by a sleep kernel on the
# prefetcher's stream: every batch's device checksum must equal the host
# checksum of its bytes (no mismatch), and recycling a staging buffer at
# settle (the JAX package's timing; a planted fault) must mismatch.
LOADER_STEPS = 40
LOADER_RECORDS = 256
LOADER_IMAGE_BATCHES = 4
LOADER_WINDOW = 30
LOADER_CHECKED = 32
LOADER_COPY_DELAY_MS = 20.0


def packed_mlm_loss(cfg, seq, num_masked):
    """BERT's MLM loss over one packed int32 batch (ids, segment ids,
    masked positions, labels side by side), sliced on the device: the
    batch leaf stays the loader's buffer."""
    from autodist_tpu_torch.models import bert
    base = bert.make_loss_fn(cfg)
    a, b, c = seq, 2 * seq, 2 * seq + num_masked

    def loss_fn(params, batch):
        return base(params, (batch[:, :a], batch[:, a:b], batch[:, b:c],
                             batch[:, c:]))
    return loss_fn


def _record_megasteps(torch, runner, device, unroll):
    """Wrap ``runner.megastep``: every step's loss and, per megastep after
    the first, the host ms per step between the completions of
    consecutive megasteps (the next block's feed included)."""
    record = {"losses": [], "ms": [], "last": None}
    inner = runner.megastep

    def megastep(state, block, shard_inputs=True):
        state, m = inner(state, block, shard_inputs)
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        if record["last"] is not None:
            record["ms"].append((now - record["last"]) * 1e3 / unroll)
        record["last"] = now
        record["losses"] += [float(x) for x in m["loss"]]
        return state, m
    runner.megastep = megastep
    return record


def _spread(times):
    """'median (min-max)' of the steady part (the first sample dropped)."""
    steady = times[1:] if len(times) > 1 else times
    return (float(np.median(steady)), min(steady), max(steady))


def loader_bert_phase(torch, fa, card, cfg, device, directory, batch_size,
                      seq, num_masked, steps, unroll):
    """Phase 18 (a); returns {path: flash launches}."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.data import NativeDataLoader, write_record_file
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    from autodist_tpu_torch.utils.tree import leaves
    t0 = time.perf_counter()
    records = np.concatenate(bert.synthetic_batch(
        cfg, LOADER_RECORDS, seq, num_masked, seed=0), axis=1)
    width = records.shape[1]
    check(width == 2 * seq + 2 * num_masked, f"record width {width}")
    path = os.path.join(directory, "bert.rec")
    write_record_file(path, records)
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    runner = ad.create_distributed_session(ad.capture(
        packed_mlm_loss(cfg, seq, num_masked),
        bert.init(cfg, torch.Generator().manual_seed(0), device=device),
        functools.partial(torch.optim.Adam, lr=1e-4),
        example_batch=records[:batch_size]))
    print(f"  (a) BERT set-up {time.perf_counter() - t0:.1f}s; {LOADER_RECORDS}"
          f" records of {width} int32 ({records[0].nbytes} bytes), a batch "
          f"{batch_size * records[0].nbytes} bytes", flush=True)

    def loader():
        return NativeDataLoader(path, (width,), np.int32, batch_size, seed=0,
                                device=device)

    # The host path: a plain iterator over a second loader, K batches
    # stacked on the host (_next_block) and placed at each megastep.
    host_loader = loader()

    def plain():
        while True:
            b = next(host_loader)
            out = np.array(b)
            host_loader.recycle(b)
            yield out
    out = {}
    runs = {}
    for name in ("host", "loader"):
        record = _record_megasteps(torch, runner, device, unroll)
        blocks, pins = [], [0]
        wired = loader() if name == "loader" else None
        source = wired if name == "loader" else plain()
        shard_block = runner.remapper.shard_block
        pin_memory = torch.Tensor.pin_memory

        def spy_shard(block, non_blocking=False):
            blocks.append([(t.device.type, t.is_pinned() if t.device.type ==
                            "cpu" and device == "cuda" else None,
                            non_blocking) for t in
                           (torch.as_tensor(x) for x in leaves(block))])
            return shard_block(block, non_blocking=non_blocking)

        def spy_pin(self, *args, **kwargs):
            pins[0] += 1
            return pin_memory(self, *args, **kwargs)
        runner.remapper.shard_block = spy_shard
        torch.Tensor.pin_memory = spy_pin
        _flash_counts(fa, reset=True)  # this path's run
        try:
            t1 = time.perf_counter()
            state, m = runner.run(runner.create_state(), source, steps,
                                  unroll=unroll)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            torch.Tensor.pin_memory = pin_memory
            del runner.remapper.shard_block
            del runner.megastep
        out[f"loader{'_host' if name == 'host' else ''}"] = counts = \
            _flash_counts(fa)
        check(int(state.step) == steps and len(record["losses"]) == steps,
              f"(a) {name}: ended at step {int(state.step)} with "
              f"{len(record['losses'])} losses")
        del state, m
        for kernel, n in counts.items():
            check(n == cfg.num_layers * steps, f"(a) {name}: {kernel} "
                  f"launched {n} times, expected {cfg.num_layers} x {steps}")
        host_blocks = [b for b in blocks if b[0][0] == "cpu"]
        runs[name] = dict(losses=record["losses"], ms=record["ms"],
                          wall=wall, pins=pins[0], blocks=host_blocks,
                          stats=(wired or host_loader).stats())
        if name == "loader":
            check(wired.backend == "native", f"(a) the loader's backend is "
                  f"{wired.backend!r}, not the native one")
            wired.close()
    host_loader.close()
    host, fed = runs["host"], runs["loader"]
    check(all(np.isfinite(fed["losses"])),
          f"(a) loader-fed losses {fed['losses']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(fed["losses"],
                                               host["losses"])]
    check(fed["losses"][0] == host["losses"][0], f"(a) step-1 loss "
          f"{fed['losses'][0]} vs the host path's {host['losses'][0]}")
    check(max(rel) <= GRAPH_LOSS_RTOL, f"(a) loader-fed losses "
          f"{fed['losses']} are off the host path's {host['losses']}")
    check(fed["pins"] == 0, f"(a) {fed['pins']} pin_memory() copies on the "
          f"loader-fed path")
    if device == "cuda":
        check(len(fed["blocks"]) >= steps // unroll and all(
            pinned and non_blocking for b in fed["blocks"]
            for _, pinned, non_blocking in b), f"(a) a host block reached "
            f"the copy unpinned or blocking: {fed['blocks'][:3]}")
    for name, run in (("host-stacked", host), ("loader-fed", fed)):
        med, lo, hi = _spread(run["ms"])
        print(f"  (a) {name}: {steps} steps of run(unroll={unroll}) "
              f"{run['wall']:.2f}s with its capture; steady ms/step (synced "
              f"per megastep, megasteps 3-{steps // unroll}) median "
              f"{med:.3f} (min {lo:.3f}, max {hi:.3f}), {batch_size / med * 1e3:.1f}"
              f" samples/s; losses {run['losses'][0]:.6f} ... "
              f"{run['losses'][-1]:.6f}; pin_memory() calls {run['pins']}; "
              f"loader stats {run['stats']} on {card}", flush=True)
    print(f"  (a) step-1 loss bitwise equal; per-step loss rel. diff max "
          f"{max(rel):.3e} (tol {GRAPH_LOSS_RTOL}); loader-fed / host-stacked"
          f" steady step {_spread(fed['ms'])[0] / _spread(host['ms'])[0]:.4f};"
          f" flash launches {out}", flush=True)
    del runner
    autodist_mod._reset_default()
    return out


def _u8_loss(cfg):
    """bench.py's uint8 fixture: images shipped as bytes, normalized on the
    device in the loss."""
    import torch
    from autodist_tpu_torch.models import resnet
    base = resnet.make_loss_fn(cfg)

    def loss_fn(params, batch):
        images, labels = batch
        return base(params, (images.to(torch.float32) / 255.0, labels))
    return loss_fn


def _host_checksum(img):
    rows = img.reshape(img.shape[0], -1).sum(1, dtype=np.int64)
    return int((rows * np.arange(1, img.shape[0] + 1, dtype=np.int64)).sum())


def loader_integrity(torch, runner, step, state, path, shape, batch_size,
                     labels, checked, fault):
    """Phase 18 (c): ``checked`` loader-fed steps with the ring on, depth 3
    and each copy held back on the prefetcher's stream; returns (state,
    batches whose device checksum differs from their host checksum, the
    loader's stats)."""
    from autodist_tpu_torch.data import DevicePrefetcher, NativeDataLoader

    class RecycleAtSettle(DevicePrefetcher):
        """The planted fault: a staging buffer recycled when its batch is
        handed out, before its copy may have read it."""

        def __init__(self, *args, **kwargs):
            self._at_settle = collections.deque()
            super().__init__(*args, **kwargs)

        def _retire(self, event, host_batch):
            self._at_settle.append(host_batch)

        def _settle(self, device_batch, event):
            super()._settle(device_batch, event)
            self._recycle(self._at_settle.popleft())

    loader = NativeDataLoader(path, shape, np.uint8, batch_size, seed=2,
                              num_threads=0, pipeline=True)
    check(loader._ring_depth > 0, "(c) the loader's ring is off")
    host = []

    def source():
        for img in loader:
            host.append(_host_checksum(img))
            yield img, labels
    delay = int(LOADER_COPY_DELAY_MS * sleep_cycles_per_ms(torch))

    def slow_shard(batch, non_blocking=False):
        torch.cuda._sleep(delay)  # on the prefetcher's stream
        return runner.remapper.shard_batch(batch, non_blocking=non_blocking)
    cls = RecycleAtSettle if fault else DevicePrefetcher
    feed = cls(source(), runner.remapper, depth=3, loader=loader,
               shard_fn=slow_shard)
    weights = torch.arange(1, batch_size + 1, dtype=torch.int64,
                           device="cuda")
    sums = torch.zeros(checked, dtype=torch.int64, device="cuda")
    for i in range(checked):
        db = next(feed)
        state, _ = step(state, db)
        sums[i] = (db[0].reshape(batch_size, -1).sum(1, dtype=torch.int64)
                   * weights).sum()
    got = sums.tolist()
    stats = loader.stats()
    loader.close()
    bad = sum(g != h for g, h in zip(got, host[:checked]))
    return state, bad, stats


def loader_resnet_phase(torch, fa, card, cfg, device, directory, image,
                        batch_size, window, checked):
    """Phase 18 (b) and (c); returns {path: flash launches}."""
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.data import (DevicePrefetcher, NativeDataLoader,
                                         write_record_file)
    from autodist_tpu_torch.models import resnet
    t0 = time.perf_counter()
    n = LOADER_IMAGE_BATCHES * batch_size
    shape = (image, image, 3)
    images = np.random.RandomState(1).randint(0, 256, (n,) + shape,
                                              dtype=np.uint8)
    labels = np.random.RandomState(0).randint(
        0, cfg.num_classes, (batch_size,)).astype(np.int32)
    path = os.path.join(directory, "images.rec")
    write_record_file(path, images)
    example = (images[:batch_size], labels)
    nbytes = images[:batch_size].nbytes
    ad = _zoo_world(torch, device)
    runner = ad.create_distributed_session(ad.capture(
        _u8_loss(cfg), resnet.init(cfg, torch.Generator().manual_seed(0),
                                   device=device),
        functools.partial(torch.optim.SGD, lr=1e-3), example_batch=example))
    step = runner.make_callable(example, aot=True)
    state = runner.create_state()
    labels_t = torch.from_numpy(labels)
    cuda = device == "cuda"
    if cuda:
        labels_t = labels_t.pin_memory()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    print(f"  (b) ResNet set-up {time.perf_counter() - t0:.1f}s; {n} uint8 "
          f"records of {shape}, a batch {nbytes} bytes", flush=True)
    out = {}
    if cuda:
        stream = torch.cuda.Stream()

        def put(host):
            with torch.cuda.stream(stream):
                dev = host.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            return dev, done

        # 1. the wire alone: two copies of one pinned batch in flight.
        src = torch.from_numpy(images[:batch_size]).pin_memory()
        q = collections.deque(put(src) for _ in range(2))
        for i in range(5 + window):
            if i == 5:
                t1 = time.perf_counter()
            q.popleft()[1].synchronize()
            q.append(put(src))
        wire = (time.perf_counter() - t1) * 1e3 / window
        for _, done in q:
            done.synchronize()
        # 2. the wire behind synchronous assembly into pinned buffers.
        ld = NativeDataLoader(path, shape, np.uint8, batch_size,
                              num_threads=0, pipeline=False)

        def issue():
            h = next(ld)
            return h, put(torch.from_numpy(h))[1]
        pend = issue()
        for i in range(3 + window):
            if i == 3:
                t1 = time.perf_counter()
            pend[1].synchronize()
            ld.recycle(pend[0])
            pend = issue()
        wire_asm = (time.perf_counter() - t1) * 1e3 / window
        pend[1].synchronize()
        ld.close()
        # 3. assembly alone, recycled: the memcpy, not an allocation.
        ld = NativeDataLoader(path, shape, np.uint8, batch_size,
                              num_threads=0, pipeline=False)
        for i in range(3 + window):
            if i == 3:
                t1 = time.perf_counter()
            ld.recycle(next(ld))
        asm = (time.perf_counter() - t1) * 1e3 / window
        ld.close()
        print(f"  (b) windows of {window}: wire {wire:.4f} ms/batch "
              f"({nbytes / wire / 1e6:.2f} GB/s, depth 2); wire + synchronous"
              f" assembly {wire_asm:.4f} ms/batch; assembly alone {asm:.4f} "
              f"ms/batch ({nbytes / asm / 1e6:.2f} GB/s) on {card}",
              flush=True)

    # 4. the loader-fed aot step against the same step on a placed batch,
    # in turns: synthetic, loader, loader, synthetic.
    synthetic = runner.remapper.shard_batch(example)
    loader = NativeDataLoader(path, shape, np.uint8, batch_size, seed=0,
                              device=device)
    check(loader.backend == "native", f"(b) the loader's backend is "
          f"{loader.backend!r}")
    feed = DevicePrefetcher(((img, labels_t) for img in loader),
                            runner.remapper, depth=2, loader=loader)
    _flash_counts(fa, reset=True)
    losses = []
    for _ in range(3):
        state, m = step(state, synthetic)
        state, m = step(state, next(feed))
        losses.append(m["loss"])
    sync()
    warm = loader.stats()["pool_fallback_allocs"]

    def window_ms(fed):
        nonlocal state
        before = feed.stats()["data_wait_ms_total"]
        sync()
        t1 = time.perf_counter()
        for _ in range(window):
            state, m = step(state, next(feed) if fed else synthetic)
            losses.append(m["loss"])
        sync()
        ms = (time.perf_counter() - t1) * 1e3 / window
        return ms, (feed.stats()["data_wait_ms_total"] - before) / window
    turns = [("synthetic", window_ms(False)), ("loader", window_ms(True)),
             ("loader", window_ms(True)), ("synthetic", window_ms(False))]
    out["loader_resnet"] = counts = _flash_counts(fa)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"(b) a loss is not finite: {losses}")
    check(not any(counts.values()), f"(b) flash kernels launched in a model "
          f"without attention: {counts}")
    stats = loader.stats()
    check(stats["pool_fallback_allocs"] == warm, f"(b) the pool allocated "
          f"{stats['pool_fallback_allocs'] - warm} buffers after warm-up")
    loader.close()
    for name, (ms, wait) in turns:
        print(f"  (b) {name:9s}: aot step {ms:.3f} ms ({batch_size / ms * 1e3:.1f}"
              f" images/s), data wait {wait:.4f} ms/step on {card}",
              flush=True)
    fed_ms = (turns[1][1][0] + turns[2][1][0]) / 2
    syn_ms = (turns[0][1][0] + turns[3][1][0]) / 2
    print(f"  (b) loader-fed / synthetic step {fed_ms / syn_ms:.4f}; loader "
          f"stats {stats} (fallback allocations after warm-up "
          f"{stats['pool_fallback_allocs'] - warm}); prefetcher "
          f"{feed.stats()}", flush=True)

    if cuda:
        t1 = time.perf_counter()
        state, bad, cstats = loader_integrity(
            torch, runner, step, state, path, shape, batch_size, labels_t,
            checked, fault=False)
        state, fault, fstats = loader_integrity(
            torch, runner, step, state, path, shape, batch_size, labels_t,
            checked, fault=True)
        print(f"  (c) {checked} batches, ring on, depth 3, copies held back "
              f"{LOADER_COPY_DELAY_MS} ms: {bad} device checksums off the "
              f"host's (limit 0; fallback allocations "
              f"{cstats['pool_fallback_allocs']}); recycled at settle (the "
              f"planted fault): {fault} off ({time.perf_counter() - t1:.1f}s)"
              f" on {card}", flush=True)
        check(bad == 0, f"(c) {bad} batches reached the step other than the "
              f"loader assembled them")
        check(fault > 0, "(c) recycling at settle read no mismatch: the "
              "check cannot see the fault it guards against")
    del runner, step, state, feed
    autodist_mod._reset_default()
    return out


def loader_phase(torch, fa, card, bert_cfg, resnet_cfg, device,
                 bert_batch=32, seq=128, num_masked=20, steps=LOADER_STEPS,
                 unroll=GRAPH_UNROLL, image=224, resnet_batch=64,
                 window=LOADER_WINDOW, checked=LOADER_CHECKED):
    """Phase 18: the input pipeline ((a) BERT through the wired loader vs
    the host-stacked feed, (b) ResNet-50 from uint8 records, (c) the
    staging buffers' integrity); returns {path: flash launches}."""
    import tempfile

    from autodist_tpu_torch.ops import build
    print(f"phase 18: the input pipeline; a {bert_cfg.num_layers}-layer BERT "
          f"(MLM, batch {bert_batch} x {seq}, {num_masked} masked, Adam 1e-4)"
          f" {steps} steps of run(unroll={unroll}) from a NativeDataLoader, "
          f"and ResNet (stages {resnet_cfg.stage_sizes}, batch {resnet_batch}"
          f" x {image}^2 uint8) through DevicePrefetcher(loader=)",
          flush=True)
    t0 = time.perf_counter()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    directory = tempfile.mkdtemp(dir=build.BUILD_DIR)
    try:
        paths = loader_bert_phase(torch, fa, card, bert_cfg, device,
                                  directory, bert_batch, seq, num_masked,
                                  steps, unroll)
        paths.update(loader_resnet_phase(torch, fa, card, resnet_cfg, device,
                                         directory, image, resnet_batch,
                                         window, checked))
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    print(f"phase 18: {time.perf_counter() - t0:.1f}s", flush=True)
    return paths


# -- phase 19: per-scope program costs ----------------------------------------
#
# (b) holds activation_live_bytes() to the forward's measured peak within
# COST_LIVE_RTOL (|estimate / measured - 1|); (c) trains under Pipeline()
# on COST_WORLD gloo ranks, held to phase 13's one-rank steps at
# PP_LOSS_RTOL / PP_UPDATE_RTOL.
COST_LIVE_RTOL = 0.5
COST_WORLD = 4


@contextlib.contextmanager
def plain_attention(fa):
    """The flash forward's plain version in place of its kernel: the
    program ``GraphItem``'s trace on ``meta`` tensors describes."""
    real = fa.flash_fwd

    def plain(q, k, v, causal=False, q_offset=0, k_offset=0, out_dtype=None,
              with_lowp=False):
        return fa.flash_fwd_reference(q, k, v, causal, q_offset, k_offset,
                                      out_dtype, with_lowp)
    fa.flash_fwd = plain
    try:
        yield
    finally:
        fa.flash_fwd = real


def forward_peak(torch, loss_fn, params, batch, device):
    """Peak allocated bytes of one forward under ``no_grad`` above the
    allocation before it (0 off the card)."""
    if device != "cuda":
        with torch.no_grad():
            loss_fn(params, batch)
        return 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = loss_fn(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def _largest(costs, key, n=3):
    top = sorted(costs.items(), key=lambda kv: -kv[1][key])[:n]
    return ", ".join(f"{k or '(none)'} {v[key]:.4g}" for k, v in top)


def cost_models_phase(torch, fa, card, device, bert_cfg, lm_cfg, bert_batch,
                      lm_tokens):
    """Phase 19 (a) and (b) on BERT (``bert_batch``: its MLM batch) and
    the stacked LM (``lm_tokens``)."""
    from autodist_tpu_torch.graph_item import GraphItem
    from autodist_tpu_torch.models import bert, lm
    from autodist_tpu_torch.pipeline import cutter
    rows = []
    for name, mod, cfg, batch in (("BERT", bert, bert_cfg, bert_batch),
                                  ("lm1b", lm, lm_cfg, (lm_tokens,))):
        params = mod.init(cfg, torch.Generator().manual_seed(0),
                          device=device)
        loss_fn = mod.make_loss_fn(cfg)
        item = GraphItem.capture(loss_fn, params, None, example_batch=batch)
        t0 = time.perf_counter()
        records = item.op_provenance()
        trace_s = time.perf_counter() - t0
        groups = cutter.top_level_costs(item)
        cut = cutter.cut_stages(item, 4)
        total = sum(st["flops"] for st in cut.stages)
        costs = item.scope_costs()
        print(f"  (a) {name}: {len(records)} ops traced on meta in "
              f"{trace_s:.2f} s; flops_estimate {item.flops_estimate():.6g};"
              f" top_level_costs " + ", ".join(
                  f"{g} {f:.6g}" for g, f, _ in groups), flush=True)
        print(f"    cut_stages(item, 4): {json.dumps(cut.to_json())}",
              flush=True)
        print(f"    largest scopes by FLOPs: {_largest(costs, 'flops')}; by "
              f"bytes: {_largest(costs, 'bytes')}", flush=True)
        check(total == cut.total_flops == item.flops_estimate(),
              f"(a) {name}: the stages sum to {total}, the cut's total is "
              f"{cut.total_flops}, flops_estimate() {item.flops_estimate()}")
        if name == "lm1b":
            per = cfg.num_layers // 4
            check([len([sc for sc in st["scopes"] if sc.startswith(
                "blocks[")]) for st in cut.stages] == [per] * 4 and
                  cut.imbalance == 0.0, f"(a) lm1b: the cut "
                  f"{[st['scopes'] for st in cut.stages]}, imbalance "
                  f"{cut.imbalance}")
        # (b) the estimate against the card.
        estimate = item.activation_live_bytes()
        never_freed = sum(r["bytes"] for r in records)
        placed = tuple(torch.as_tensor(np.asarray(b)).to(device)
                       for b in batch)
        with plain_attention(fa):
            peaks = [forward_peak(torch, loss_fn, params, placed, device)
                     for _ in range(2)]
        flash = forward_peak(torch, loss_fn, params, placed, device)
        b, s = placed[0].shape[0], placed[0].shape[1] - (name == "lm1b")
        scores = b * cfg.num_heads * s * s * 4
        rows.append((name, estimate, never_freed, peaks, flash, scores))
        del params, item, placed
        if device == "cuda":
            torch.cuda.empty_cache()
    for name, estimate, never_freed, (peak, again), flash, scores in rows:
        ratio = estimate / peak if peak else float("nan")
        floor = abs(again / peak - 1) if peak else 0.0
        fault = abs(never_freed / peak - 1) if peak else float("inf")
        print(f"  (b) {name}: activation_live_bytes {estimate / 2**20:.1f} "
              f"MiB; the forward's measured peak (plain attention) "
              f"{peak / 2**20:.1f} MiB, again {again / 2**20:.1f} MiB; "
              f"estimate / measured {ratio:.4f} (|1 - ratio| tolerance "
              f"{COST_LIVE_RTOL}; floor {floor:.3e}, the never-freeing "
              f"scan {never_freed / 2**20:.1f} MiB: {fault:.3f}); the flash "
              f"path's peak {flash / 2**20:.1f} MiB, gap "
              f"{(peak - flash) / 2**20:.1f} MiB beside one (b, h, s, s) f32"
              f" score tensor of {scores / 2**20:.1f} MiB; on {card}",
              flush=True)
        if device == "cuda":
            check(floor < COST_LIVE_RTOL < fault, f"(b) {name}: the "
                  f"tolerance {COST_LIVE_RTOL} does not lie between the "
                  f"floor {floor} and the fault's reading {fault}")
            check(abs(ratio - 1) <= COST_LIVE_RTOL, f"(b) {name}: "
                  f"activation_live_bytes {estimate} vs the measured peak "
                  f"{peak} ({ratio:.4f})")
    return rows


def pp_auto_rank(rank, world, port, spec):
    """One rank of :func:`cost_phase` (c): a gloo world over ``localhost``
    on device 0. Builds ``Pipeline()`` and ``Pipeline(4, 8)`` on this
    rank's spec of ``world`` devices, then trains the stacked LM under
    ``Pipeline()`` ``spec["steps"]`` SGD steps, and again with the whole
    gradients summed over the data group alone (the planted fault).
    Prints {the resolved stage and microbatch counts, the protos' equality,
    the cut, run: losses, launches, ms, mesh, update error against the
    reference, digest of the whole params, stored bytes, peak memory}."""
    import datetime
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.graph_item import GraphItem
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.pipeline import cutter
    from autodist_tpu_torch.resource_spec import ResourceSpec
    spec = json.loads(spec)
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    for knob in ("AUTODIST_PIPELINE_STAGES", "AUTODIST_MICROBATCHES",
                 "AUTODIST_PIPELINE_SCHEDULE"):
        os.environ.pop(knob, None)
    cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
        torch, spec["dtype"])))
    params, init = _lm_init(torch, cfg, device)
    tokens = sp_tokens(cfg, spec["batch"], spec["seq"])
    ref = torch.load(spec["ref"], map_location=device)
    sgd = functools.partial(torch.optim.SGD, lr=spec["lr"])
    item = GraphItem.capture(lm.make_loss_fn(cfg), params, sgd,
                             example_batch=(tokens,))
    rspec = ResourceSpec.world(torch.device(device), rank, world)
    out = {"rank": rank,
           "resolved": list(cutter.resolve_stages(item, rspec)),
           "micro": cutter.resolve_microbatches(item, world)}
    auto = S.Pipeline().build(item, rspec)
    out["cut"] = cutter.last_cut().to_json()
    fixed = S.Pipeline(world, 2 * world).build(item, rspec)
    auto.proto.id = fixed.proto.id = ""
    out["proto_equal"] = (auto.proto.SerializeToString() ==
                          fixed.proto.SerializeToString())
    del item

    def data_only(runner):  # whole gradients over the data group alone
        runner._grad_group = runner.program.mesh.group("data")

    for key in ("auto", "data_only"):
        run = _train(torch, fa, device, S.Pipeline(), lm.make_loss_fn(cfg),
                     params, (tokens,), spec["steps"], spec["lr"],
                     prepare=data_only if key == "data_only" else None)
        kinds = run.runner.var_kinds
        final = flatten_params(run.runner.logical_params(run.state))
        stored = flatten_params(run.state.params)
        out[key] = {
            "losses": run.losses, "launches": run.launches, "ms": run.times,
            "mesh": dict(run.runner.program.mesh.shape),
            "micro": run.runner.program.parallel_context()
            .pipeline_microbatches,
            "update_error": update_error(torch, final, ref, init),
            "whole": _digest(torch, (t for n, t in sorted(stored.items())
                                     if kinds[n][0] != "tp")),
            "stored_bytes": sum(t.numel() * t.element_size()
                                for t in stored.values()),
            "whole_bytes": sum(t.numel() * t.element_size()
                               for t in final.values()),
            "peak_bytes": run.peak}
        if key == "auto":
            # Two more steps through Runner.run, whose end gathers every
            # rank's telemetry snapshot on the chief over the c10d store
            # and publishes the pipeline.* gauges.
            from autodist_tpu_torch import observability
            run.runner.run(run.state, itertools.repeat(run.batch), 2)
            gauges = observability.registry().snapshot()["gauges"]
            out["gathered"] = sorted(
                s["host"] for s in observability.cluster.gathered())
            out["pipeline"] = {k: v for k, v in gauges.items()
                               if k.startswith("pipeline.")}
            out["imbalance"] = cutter.last_cut().imbalance
        del run, final, stored
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def cost_phase(torch, fa, card, device, reference, bert_cfg, vocab=32000,
               dim=1024, heads=16, layers=PP_LAYERS, max_len=PP_SEQ,
               batch=PP_BATCH, steps=PP_STEPS, bert_batch=32, bert_seq=128,
               num_masked=20):
    """Phase 19: per-scope program costs, (a) and (b) on BERT (``bert_cfg``,
    phase 4's MLM batch) and the stacked LM (phase 13's), (c) ``Pipeline()``
    choosing its own stage count on ``COST_WORLD`` gloo ranks, held to one
    rank's steps (``reference``: phase 13's (losses, floor, path of the
    final params)). Returns {path: flash launches, summed over the
    ranks}."""
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    t_phase = time.perf_counter()
    cfg = T.TransformerConfig(vocab=vocab, dim=dim, num_heads=heads,
                              num_layers=layers, max_len=max_len,
                              causal=True, dtype=torch.bfloat16,
                              scan_layers=True)
    seq = max_len
    tokens = sp_tokens(cfg, batch, seq)
    print(f"phase 19: per-scope program costs; BERT (width {bert_cfg.dim}, "
          f"{bert_cfg.num_layers} layers, MLM {bert_batch} x {bert_seq}, "
          f"{num_masked} masked) and the LM at lm1b's widths (vocab {vocab}, "
          f"dim {dim}, {heads} heads, {layers} layers, scan_layers=True, "
          f"{batch} x {seq})", flush=True)
    cost_models_phase(torch, fa, card, device, bert_cfg, cfg,
                      bert.synthetic_batch(bert_cfg, bert_batch, bert_seq,
                                           num_masked), tokens)
    ref_losses, floor, ref_path = reference
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = {"device": device, "config": fields, "dtype": "bfloat16",
            "seq": seq, "batch": batch, "steps": steps, "lr": PP_LR,
            "ref": ref_path}
    ranks = _spawn_ranks(COST_WORLD, "--pp-auto", json.dumps(spec),
                         "a phase 19 rank")
    r0 = ranks[0]
    auto = [r["auto"] for r in ranks]
    fault = (_rel(r0["data_only"]["losses"], ref_losses),
             max(r["data_only"]["update_error"] for r in ranks))
    rel = _rel(auto[0]["losses"], ref_losses)
    err = max(r["update_error"] for r in auto)
    micro = 2 * COST_WORLD
    per_rank = layers // COST_WORLD * micro
    want = {k: per_rank * steps for k in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv")}
    print(f"  (c) {COST_WORLD} gloo ranks on one device, Pipeline() with no "
          f"arguments: resolve_stages {r0['resolved']}, "
          f"resolve_microbatches {r0['micro']}, the proto "
          f"{'equals' if r0['proto_equal'] else 'differs from'} "
          f"Pipeline({COST_WORLD}, {micro})'s; the cut "
          f"{json.dumps(r0['cut'])}", flush=True)
    print(f"    mesh {auto[0]['mesh']}, {auto[0]['micro']} microbatches: "
          f"losses {', '.join(f'{x:.6f}' for x in auto[0]['losses'])}; vs "
          f"phase 13's one rank: loss {rel:.3e} (tol {PP_LOSS_RTOL}), update "
          f"{err:.3e} (tol {PP_UPDATE_RTOL}); floor {floor[0]:.3e} / "
          f"{floor[1]:.3e}; planted fault (whole gradients over the data "
          f"group alone) {fault[0]:.3e} / {fault[1]:.3e}; whole params equal "
          f"on every rank: {len({r['whole'] for r in auto}) == 1}; flash "
          f"launches per rank {auto[0]['launches']}", flush=True)
    print(f"    telemetry after two more Runner.run steps: rank 0 gathered "
          f"the snapshots of ranks {r0['gathered']} (the others their own: "
          f"{[r['gathered'] for r in ranks[1:]]}); pipeline gauges "
          f"{r0['pipeline']}, the cut's imbalance {r0['imbalance']:.4f}",
          flush=True)
    check(r0["gathered"] == list(range(COST_WORLD)) and all(
        len(r["gathered"]) == 1 for r in ranks[1:]), f"(c) gathered "
        f"{[r['gathered'] for r in ranks]}")
    check(r0["pipeline"].get("pipeline.stages") == COST_WORLD and
          r0["pipeline"].get("pipeline.microbatches") == micro and
          r0["pipeline"].get("pipeline.bubble_fraction") == round(
              (COST_WORLD - 1) / (micro + COST_WORLD - 1), 4),
          f"(c) pipeline gauges {r0['pipeline']}")
    for i, r in enumerate(auto):
        print(f"    rank {i}: stores {r['stored_bytes']} of "
              f"{r['whole_bytes']} bytes "
              f"({100 * r['stored_bytes'] / r['whole_bytes']:.1f}%); peak "
              f"memory {r['peak_bytes'] / 2**30:.2f} GiB; ms per step "
              f"(host-inclusive) {', '.join(f'{x:.1f}' for x in r['ms'])}; "
              f"on {card}", flush=True)
    check(all(r["resolved"] == [COST_WORLD, "auto"] and r["micro"] == micro
              and r["proto_equal"] for r in ranks), f"(c) resolve_stages "
          f"{[r['resolved'] for r in ranks]}, resolve_microbatches "
          f"{[r['micro'] for r in ranks]}, protos equal "
          f"{[r['proto_equal'] for r in ranks]}")
    _cp_tolerances("phase 19 (c)", floor, {"data_only": fault},
                   (PP_LOSS_RTOL, PP_UPDATE_RTOL))
    check(rel <= PP_LOSS_RTOL, f"(c) losses {auto[0]['losses']} vs one "
          f"rank's {ref_losses} ({rel:.3e})")
    check(err <= PP_UPDATE_RTOL, f"(c) update error {err:.3e}")
    check(all(r["losses"] == auto[0]["losses"] for r in auto),
          "(c) the ranks' losses differ")
    check(len({r["whole"] for r in auto}) == 1,
          "(c) the whole params differ across the ranks")
    check(all(r["mesh"] == {"data": 1, "pipe": COST_WORLD} and
              r["micro"] == micro for r in auto),
          f"(c) mesh {auto[0]['mesh']}, microbatches {auto[0]['micro']}")
    for r in auto:
        check(r["launches"] == want, f"(c) launches {r['launches']}, "
              f"expected {want}")
    print(f"  (d) phase 19 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {f"pp_auto_gloo{COST_WORLD}": {
        k: sum(r["launches"][k] for r in auto) for k in want}}


# Phase 20: in-process observability on BERT-base training.
OBS_STEPS = 40
OBS_SAVE_EVERY = 20
OBS_UNROLL = 4
OBS_TIMED = 10          # megasteps a timing of the graph step replays
OBS_PROFILED = 8        # steps of the AUTODIST_TRACE=profiler run
OBS_OOM_AT = 5          # chaos oom_at: the second megastep's first step
# wall_ms against the graph step's CUDA-event time, and the goodput
# ledger's hfu against the MFU from that time: each must lie above its
# floor (two timings of the step) and the wall's below the planted fault
# (the loop's clock on the host, with no event).
OBS_WALL_RTOL = 0.03
OBS_MFU_RTOL = 0.03
OBS_SPANS = ("capture", "strategy-build", "transform", "compile",
             "step-loop", "checkpoint-save")
# CheckpointManager.run's goodput against the phase's own figure (the
# CUDA-event intervals less the data wait, the timed save stalls before
# the last dispatch and the capture): above the floor (two runs' ratios)
# and below the planted fault (the old arithmetic: every in-loop save).
OBS_GOODPUT_RTOL = 0.02


def _obs_session(torch, cfg, device, records, batch_size, seq, num_masked):
    """A fresh one-rank ``AllReduce()`` BERT world (phase 18's packed MLM
    loss, Adam 1e-4, the seeded init), built under the telemetry setting
    of the moment (a Runner resolves it at construction)."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    return ad.create_distributed_session(ad.capture(
        packed_mlm_loss(cfg, seq, num_masked),
        bert.init(cfg, torch.Generator().manual_seed(0), device=device),
        functools.partial(torch.optim.Adam, lr=1e-4),
        example_batch=records[:batch_size]))


def _fed(loader):
    """A loader's batches as owned host arrays, each buffer recycled."""
    while True:
        b = next(loader)
        out = np.array(b)
        loader.recycle(b)
        yield out


def _telemetry_files():
    """{path: (size, mtime)} of every file telemetry writes: traces, flight
    and goodput files, the memory / OOM reports and the calibration files,
    one per card and program (the log_*.txt files are the logger's)."""
    from autodist_tpu_torch import const
    from autodist_tpu_torch.tuner import calibration
    out = {}
    for d in (const.DEFAULT_TRACE_DIR, const.DEFAULT_LOG_DIR,
              os.path.dirname(calibration.default_path("key"))):
        if os.path.isdir(d):
            for f in os.listdir(d):
                if not f.startswith("log_"):
                    st = os.stat(os.path.join(d, f))
                    out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    cal = calibration.default_path()
    if os.path.exists(cal):
        st = os.stat(cal)
        out[cal] = (st.st_size, st.st_mtime_ns)
    return out


def _set_telemetry(**knobs):
    """Set (value) or drop (None) AUTODIST_* knobs and re-read them."""
    from autodist_tpu_torch import observability
    for name, value in knobs.items():
        if value is None:
            os.environ.pop(f"AUTODIST_{name}", None)
        else:
            os.environ[f"AUTODIST_{name}"] = str(value)
    observability.refresh()


def _graph_step_ms(torch, runner, state, block, n=OBS_TIMED, warmup=3):
    """ms per step of the runner's captured K-step graph on a placed block:
    the median interval between CUDA events recorded after each of ``n``
    replays, after ``warmup`` replays (what ran before, such as a loader's
    threads filling its ring, settles first); the state keeps training."""
    for _ in range(warmup):
        state, _ = runner.megastep(state, block, shard_inputs=False)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    events[0].record()
    for ev in events[1:]:
        state, _ = runner.megastep(state, block, shard_inputs=False)
        ev.record()
    return state, _steady_ms(events)


def _dispatch_events(torch, runner):
    """Record a CUDA event after each of the runner's megasteps (a wrapper:
    ``del runner.megastep`` removes it); returns the list they go to."""
    events = []
    inner = runner.megastep

    def megastep(state, block, shard_inputs=True):
        out = inner(state, block, shard_inputs)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out
    runner.megastep = megastep
    return events


def _steady_ms(events):
    """Median ms per step between consecutive dispatches' events."""
    events[-1].synchronize()
    return float(np.median([a.elapsed_time(b) / OBS_UNROLL
                            for a, b in zip(events, events[1:])]))


def _goodput_figure(snap, evs, saves_timed, steps):
    """Phase 20 (a): goodput of a CheckpointManager.run as the phase
    reckons it: the billed CUDA-event dispatch intervals less the data
    wait, the host-timed save calls before the last dispatch (a save at
    the last step comes after it) and the capture; beside it, the old
    arithmetic, which subtracted every save inside the step loop."""
    hists, counters = snap["histograms"], snap["counters"]
    lat = hists["step.latency_ms"]
    billed = lat["total"] * counters["step.count"] / lat["count"]
    wait = (hists.get("step.data_wait_ms") or {}).get("total", 0.0)
    stalls = 1e3 * sum(dt for step, dt, started in saves_timed
                       if started and step < steps)
    loops = [(e["ts"], e["ts"] + e["dur"]) for e in evs
             if e["name"] == "step-loop"]

    def inside(name):
        return sum(max(0.0, min(b, e["ts"] + e["dur"]) - max(a, e["ts"]))
                   for e in evs if e["name"] == name
                   for a, b in loops) / 1e3
    capture = inside("compile")
    loop_saves = inside("checkpoint-save")
    return {"billed_ms": billed, "data_wait_ms": wait, "stalls_ms": stalls,
            "capture_ms": capture, "loop_saves_ms": loop_saves,
            "saves": [(st, round(dt * 1e3, 3)) for st, dt, ok in saves_timed
                      if ok],
            "expected_ms": billed - wait - stalls - capture,
            "old_ms": max(0.0, billed - wait - loop_saves - capture)}


def _flash_in_loop(torch, path, want):
    """Phase 20 (d): the flash kernels of the torch.profiler trace at
    ``path``, each held to the ``step-loop`` range by its launch (the
    runtime call of the same correlation id). Returns (per kernel count,
    count launched inside the range, step-loop ranges)."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    loops = [(e["ts"], e["ts"] + e["dur"]) for e in evs
             if e.get("name") == "step-loop" and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    launch = {e["args"]["correlation"]: e["ts"] for e in evs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in (e.get("args") or {})}
    counts = dict.fromkeys(want, 0)
    inside = 0
    for e in evs:
        if e.get("cat") != "kernel":
            continue
        name = next((k for k in want if k in e.get("name", "")), None)
        if name is None:
            continue
        counts[name] += 1
        ts = launch.get((e.get("args") or {}).get("correlation"))
        if ts is not None and any(a <= ts <= b for a, b in loops):
            inside += 1
    return counts, inside, loops


def observe_phase(torch, fa, card, cfg, device, directory, batch_size=32,
                  seq=128, num_masked=20, steps=OBS_STEPS):
    """Phase 20; returns {path: flash launches}."""
    import warnings
    from autodist_tpu_torch import const, observability
    from autodist_tpu_torch import runner as runner_mod
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.data import NativeDataLoader, write_record_file
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.observability import attribution, goodput, memory
    from autodist_tpu_torch.tuner import calibration
    t_phase = time.perf_counter()
    records = np.concatenate(bert.synthetic_batch(
        cfg, LOADER_RECORDS, seq, num_masked, seed=0), axis=1)
    width = records.shape[1]
    path = os.path.join(directory, "obs.rec")
    write_record_file(path, records)
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    want = {k: cfg.num_layers * steps for k in names}

    def loader():
        return NativeDataLoader(path, (width,), np.int32, batch_size, seed=0,
                                device=device)

    print(f"phase 20: in-process observability; BERT-base MLM {batch_size} x"
          f" {seq}, {num_masked} masked, Adam 1e-4, {steps} steps of "
          f"unroll={OBS_UNROLL} from a NativeDataLoader", flush=True)
    saved_knobs = {k: os.environ.get(f"AUTODIST_{k}")
                   for k in ("TELEMETRY", "TRACE", "CHAOS")}
    deterministic = torch.are_deterministic_algorithms_enabled()
    out = {}
    try:
        # (a) CheckpointManager.run, telemetry on then off, in one process.
        warnings.filterwarnings("ignore", message=".*deterministic.*")
        torch.use_deterministic_algorithms(True, warn_only=True)
        runs = {}
        for label, on in (("on", 1), ("off", 0), ("on2", 1)):
            _set_telemetry(TELEMETRY=on, TRACE=None, CHAOS=None)
            observability.reset()
            files = _telemetry_files()
            t0 = time.perf_counter()
            runner = _obs_session(torch, cfg, device, records, batch_size,
                                  seq, num_masked)
            check((runner._obs is not None) == bool(on),
                  f"(a) telemetry {label}: the runner's handle is "
                  f"{runner._obs}")
            feed = loader()
            mgr = CheckpointManager(runner, os.path.join(directory,
                                                         f"ckpt_{label}"),
                                    save_interval_steps=OBS_SAVE_EVERY,
                                    max_to_keep=1)
            saves_timed = []   # (step, host s, started)
            inner_save = mgr.save

            def timed_save(step, state, force=False, _inner=inner_save,
                           _log=saves_timed):
                t = time.perf_counter()
                started = _inner(step, state, force)
                _log.append((step, time.perf_counter() - t, started))
                return started
            mgr.save = timed_save
            _flash_counts(fa, reset=True)
            t1 = time.perf_counter()
            state, m = mgr.run(runner.create_state(), _fed(feed), steps,
                               unroll=OBS_UNROLL)
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t1
            counts = _flash_counts(fa)
            out[f"obs_ckpt_{label}"] = counts
            params = {n: t.detach().clone() for n, t in
                      flatten_params(state.params).items()}
            run = dict(counts=counts, params=params, loop_s=loop_s,
                       total_s=time.perf_counter() - t0,
                       saves=mgr.all_steps(),
                       loss=float(m["loss"][-1]), files=files)
            if on:
                trace = observability.flush_trace(
                    os.path.join(directory, f"obs_trace_{label}.json"))
                with open(trace) as f:
                    evs = [e for e in json.load(f)["traceEvents"]
                           if e.get("ph") == "X"]
                spans = {e["name"] for e in evs}
                snap = observability.registry().snapshot()
                run.update(spans=spans, hist=snap["histograms"].get(
                    "step.latency_ms", {}), goodput=goodput.last_summary(),
                    n_saves=snap["counters"].get("checkpoint.saves"),
                    events=sorted({e["kind"] for e in
                                   observability.recorder.events()}))
                run["goodput_check"] = _goodput_figure(
                    snap, evs, saves_timed, steps)
            else:
                run["written"] = sorted(
                    p for p, st in _telemetry_files().items()
                    if files.get(p) != st)
            mgr.close()
            feed.close()
            runs[label] = run
            del runner, state, m, mgr
        torch.use_deterministic_algorithms(deterministic)
        on, off = runs["on"], runs["off"]
        gc, gc2 = on["goodput_check"], runs["on2"]["goodput_check"]
        gp_ms = [r["goodput"]["goodput_ms"] for r in (on, runs["on2"])]
        gp_rel = [abs(g - c["expected_ms"]) / c["expected_ms"]
                  for g, c in zip(gp_ms, (gc, gc2))]
        gp_floor = abs(gp_ms[0] / gc["expected_ms"] -
                       gp_ms[1] / gc2["expected_ms"])
        gp_fault = abs(gc["old_ms"] - gc["expected_ms"]) / gc["expected_ms"]
        print(f"  (a) goodput of CheckpointManager.run: {gp_ms[0]:.3f} / "
              f"{gp_ms[1]:.3f} ms ({on['goodput']['goodput_pct']}% / "
              f"{runs['on2']['goodput']['goodput_pct']}% of the segment) vs "
              f"the phase's figure {gc['expected_ms']:.3f} / "
              f"{gc2['expected_ms']:.3f} ms = billed {gc['billed_ms']:.3f} "
              f"- data wait {gc['data_wait_ms']:.3f} - timed save stalls "
              f"before the last dispatch {gc['stalls_ms']:.3f} (saves "
              f"{gc['saves']}) - capture {gc['capture_ms']:.3f}; rel "
              f"{gp_rel[0]:.3e} / {gp_rel[1]:.3e} (tol {OBS_GOODPUT_RTOL}; "
              f"floor {gp_floor:.3e}); the old arithmetic (every in-loop "
              f"save, {gc['loop_saves_ms']:.3f} ms) reads "
              f"{gc['old_ms']:.3f} ms: rel {gp_fault:.3e}", flush=True)
        check(min(gp_ms) > 0, f"(a) goodput {gp_ms} not above 0")
        check(gp_floor < OBS_GOODPUT_RTOL < gp_fault, f"(a) the goodput "
              f"tolerance {OBS_GOODPUT_RTOL} not between the floor "
              f"{gp_floor:.3e} and the old arithmetic {gp_fault:.3e}")
        check(max(gp_rel) <= OBS_GOODPUT_RTOL, f"(a) goodput {gp_ms} vs "
              f"the phase's figures ({gp_rel})")
        same = [n for n in on["params"]
                if torch.equal(on["params"][n], off["params"][n])]
        diff = max(float((on["params"][n].float() - off["params"][n].float())
                         .abs().max()) for n in on["params"])
        hist = on["hist"]
        print(f"  (a) CheckpointManager.run: telemetry on {on['loop_s']:.2f} "
              f"s ({on['total_s']:.2f} s with the session), off "
              f"{off['loop_s']:.2f} s ({off['total_s']:.2f} s); "
              f"{on['n_saves']} saves (the first boundary's, as no "
              f"checkpoint exists yet, then every {OBS_SAVE_EVERY} steps), "
              f"kept {on['saves']} / {off['saves']}; last loss {on['loss']:.6f} / "
              f"{off['loss']:.6f}; params bitwise equal {len(same)} of "
              f"{len(on['params'])} (max |diff| {diff:.3e}); flash launches "
              f"{on['counts']} / {off['counts']}; step.latency_ms p50 "
              f"{hist.get('p50', float('nan')):.3f} over {hist.get('count')}"
              f" dispatches; spans {sorted(on['spans'])}; flight events "
              f"{on['events']}; goodput {on['goodput']['goodput_pct']}% of "
              f"{on['goodput']['wall_ms']:.0f} ms, classes "
              f"{on['goodput']['classes']}; files written with telemetry "
              f"off: {off['written']}", flush=True)
        n_diff = len(on["params"]) - len(same)
        check(n_diff == 0, f"(a) {n_diff} params differ between telemetry "
              f"on and off (max |diff| {diff:.3e})")
        for label, run in runs.items():
            check(run["counts"] == want, f"(a) telemetry {label}: launches "
                  f"{run['counts']}, expected {want}")
        check(set(OBS_SPANS) <= on["spans"], f"(a) the trace lacks "
              f"{sorted(set(OBS_SPANS) - on['spans'])}")
        check(off["written"] == [], f"(a) telemetry off wrote "
              f"{off['written']}")
        check(hist.get("count") == steps // OBS_UNROLL and
              on["goodput"]["steps"] == steps,
              f"(a) step.latency_ms count {hist.get('count')}, goodput steps"
              f" {on['goodput']['steps']}")

        # (b) + (c) Runner.run(unroll=4), the capture in a first run fed by
        # the loader. The measured runs take device-resident batches: the
        # step is then the graph step's device time, which two timings of
        # its replays bracket, and the host runs ahead of the device (the
        # planted fault's clock reads the enqueue). A loader-fed run after
        # them shows the input pipeline's exposed start-up.
        _set_telemetry(TELEMETRY=1)
        observability.reset()
        runner = _obs_session(torch, cfg, device, records, batch_size, seq,
                              num_masked)
        feed = loader()
        state, _ = runner.run(runner.create_state(), feed, 2 * OBS_UNROLL,
                              unroll=OBS_UNROLL)
        placed = [runner.remapper.shard_batch(
            records[i * batch_size:(i + 1) * batch_size])
            for i in range(OBS_UNROLL)]
        block = torch.stack(placed)
        state, timed0 = _graph_step_ms(torch, runner, state, block)
        observability.reset()  # this run's registry, spans, goodput clock
        events = _dispatch_events(torch, runner)
        state, _ = runner.run(state, itertools.cycle(placed), steps,
                              unroll=OBS_UNROLL)
        steady_on = _steady_ms(events)
        attr = attribution.last_summary()
        gp = goodput.last_summary()
        mem = memory.last_summary()
        state, timed1 = _graph_step_ms(torch, runner, state, block)
        # The same loop with the telemetry handle a Runner built under
        # AUTODIST_TELEMETRY=0 holds: no clock, no registry, no span.
        obs_handle, runner._obs = runner._obs, None
        events.clear()
        try:
            state, _ = runner.run(state, itertools.cycle(placed), steps,
                                  unroll=OBS_UNROLL)
        finally:
            runner._obs = obs_handle
            del runner.megastep
        steady_off = _steady_ms(events)
        orig = runner_mod.DispatchClock.__init__
        runner_mod.DispatchClock.__init__ = \
            lambda self, device, **kw: orig(self, "cpu", **kw)
        try:
            state, _ = runner.run(state, itertools.cycle(placed), steps,
                                  unroll=OBS_UNROLL)
            fault = attribution.last_summary()["wall_ms"]
        finally:
            runner_mod.DispatchClock.__init__ = orig
        state, _ = runner.run(state, feed, steps, unroll=OBS_UNROLL)
        fed = attribution.last_summary()
        cal_path = calibration.path_for(runner, OBS_UNROLL)
        cal = calibration.Calibration.load(cal_path)
        timed = 0.5 * (timed0 + timed1)
        floor = abs(timed0 - timed1) / timed
        wall_rel = abs(attr["wall_ms"] - timed) / timed
        fault_rel = abs(fault - timed) / timed
        total = sum(attr[c] for c in attribution.COMPONENTS)
        flops = 3.0 * runner.program.graph_item.flops_estimate()
        mfu = flops / (timed / 1e3) / PEAK_BF16_FLOPS
        mfu0 = flops / (timed0 / 1e3) / PEAK_BF16_FLOPS
        mfu1 = flops / (timed1 / 1e3) / PEAK_BF16_FLOPS
        mfu_floor = abs(mfu0 - mfu1) / mfu
        mfu_rel = abs(gp["hfu"] - mfu) / mfu
        print(f"  (b) attribution over {attr['steps']} steps "
              f"({attr['dispatches']} dispatches): " + ", ".join(
                  f"{c} {attr[c]:.4f}" for c in attribution.COMPONENTS) +
              f" = {total:.5f} vs wall_ms {attr['wall_ms']:.5f}; raw "
              f"compute {attr['raw_compute_ms']:.4f} ms, raw comms "
              f"{attr['raw_comms_ms']:.4f} ms; sources {attr['sources']}; "
              f"calibration {os.path.basename(cal_path)}: compute scale "
              f"{cal.compute_scale:.4f} after {len(cal.samples)} samples",
              flush=True)
        print(f"    wall_ms {attr['wall_ms']:.4f} vs the graph step by CUDA "
              f"events {timed0:.4f} / {timed1:.4f} ms (floor {floor:.3e}): "
              f"rel {wall_rel:.3e} (tol {OBS_WALL_RTOL}); planted fault "
              f"(the host clock, no event) {fault:.4f} ms, rel "
              f"{fault_rel:.3e}; steady step (events after each "
              f"dispatch) telemetry on {steady_on:.4f} / off "
              f"{steady_off:.4f} ms = {steady_on / steady_off:.4f}; fed by "
              f"the loader: wall_ms {fed['wall_ms']:.4f}, data_wait_ms "
              f"{fed['data_wait_ms']:.4f}", flush=True)
        print(f"  (c) goodput: hfu {gp['hfu']:.5f}, mfu {gp['mfu']:.5f} "
              f"(run-level, {gp['wall_ms']:.1f} ms since the reset, "
              f"{gp['goodput_pct']}% productive); 3 x flops_estimate "
              f"{flops:.6g} / the CUDA-event step / {PEAK_BF16_FLOPS:.4g}: "
              f"{mfu:.5f} (floor {mfu_floor:.3e}); rel {mfu_rel:.3e} (tol "
              f"{OBS_MFU_RTOL})", flush=True)
        pred = mem.get("predicted", {})
        ratio = mem.get("predicted_peak_gb", 0) / max(
            1e-12, mem.get("measured_peak_gb", 0))
        print(f"    memory ledger: predicted peak "
              f"{mem.get('predicted_peak_gb', 0):.4f} GiB = " + " + ".join(
                  f"{c.replace('_bytes', '')} {v / 2**30:.4f}"
                  for c, v in pred.items()) +
              f"; measured peak {mem.get('measured_peak_gb', 0):.4f} GiB "
              f"({mem.get('measured_source')}); predicted / measured "
              f"{ratio:.4f}; resident error {mem.get('prediction_error_pct')}% on "
              f"{card}", flush=True)
        check(abs(total - attr["wall_ms"]) <= 5e-5 * len(
            attribution.COMPONENTS), f"(b) components sum {total} != "
            f"wall_ms {attr['wall_ms']}")
        # The calibrated terms are the program's own (its file, fed by its
        # own steady runs): none can exceed the wall it is a part of.
        over = {c: attr[c] for c in ("host_dispatch_ms", "device_compute_ms",
                                     "exposed_comms_ms")
                if attr[c] > attr["wall_ms"] * (1 + OBS_WALL_RTOL)}
        check(not over, f"(b) calibrated terms {over} exceed wall_ms "
              f"{attr['wall_ms']} (+{OBS_WALL_RTOL})")
        check(floor < OBS_WALL_RTOL < fault_rel, f"(b) tolerance "
              f"{OBS_WALL_RTOL} not between the floor {floor:.3e} and the "
              f"planted fault {fault_rel:.3e}")
        check(wall_rel <= OBS_WALL_RTOL, f"(b) wall_ms {attr['wall_ms']} "
              f"vs the CUDA-event step {timed} ({wall_rel:.3e})")
        check(mfu_floor < OBS_MFU_RTOL and mfu_rel <= OBS_MFU_RTOL,
              f"(c) hfu {gp['hfu']} vs {mfu} ({mfu_rel:.3e}, floor "
              f"{mfu_floor:.3e})")
        predicted_sum = sum(pred.values())
        check(pred and abs(predicted_sum - mem["predicted_peak_bytes"]) <= 0,
              f"(b) predicted classes sum {predicted_sum} != peak "
              f"{mem.get('predicted_peak_bytes')}")

        # (d) AUTODIST_TRACE=profiler: the kernels inside step-loop.
        _set_telemetry(TRACE="profiler")
        trace = os.path.join(const.DEFAULT_TRACE_DIR, "trace-rank0.json")
        want_d = {k: cfg.num_layers * OBS_PROFILED for k in names}
        # A profile can come back short of device events (a traced graph
        # replay's kernel now and then, or all of them): profile again, up
        # to PROFILE_ATTEMPTS times, until every launch is in the trace.
        # Every traced flash kernel must have been launched inside the
        # step-loop range.
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            _flash_counts(fa, reset=True)
            state, _ = runner.run(state, feed, OBS_PROFILED,
                                  unroll=OBS_UNROLL)
            launched = _flash_counts(fa)
            counts, inside, loops = _flash_in_loop(
                torch, trace, [k + "_" for k in ("flash_fwd", "flash_bwd_dq",
                                                  "flash_bwd_dkv")])
            if list(counts.values()) == list(want_d.values()):
                break
            if not sum(counts.values()):
                TIMINGS["empty"] += 1
        TIMINGS["profiles"] += attempt
        _set_telemetry(TRACE=None)
        print(f"  (d) AUTODIST_TRACE=profiler: {trace} ({attempt} "
              f"profile(s)); step-loop ranges {len(loops)}; flash kernels in"
              f" the trace {counts}, {inside} launched inside step-loop; "
              f"launches counted {launched}", flush=True)
        check(launched == want_d, f"(d) launches {launched}, expected "
              f"{want_d}")
        check(len(loops) == 1 and inside == sum(counts.values()) and all(
            0 < n <= w for n, w in zip(counts.values(), want_d.values())),
              f"(d) {inside} of {sum(counts.values())} flash kernels inside "
              f"{len(loops)} step-loop range(s); per kernel {counts}")

        # (e) OOM forensics: chaos oom_at, then a real allocator OOM.
        report = os.path.join(const.DEFAULT_LOG_DIR, "oom_report.json")
        if os.path.exists(report):
            os.remove(report)
        _set_telemetry(CHAOS=f"oom_at={OBS_OOM_AT}")
        raised = None
        try:
            runner.run(state, feed, 2 * OBS_UNROLL, unroll=OBS_UNROLL)
        except RuntimeError as e:
            raised = e
        finally:
            _set_telemetry(CHAOS=None)
        oom_events = [e for e in observability.recorder.events()
                      if e["kind"] == "oom"]
        with open(report) as f:
            rep = json.load(f)
        real = None
        try:
            torch.empty(2 * torch.cuda.get_device_properties(0).total_memory,
                        dtype=torch.uint8, device=device)
        except torch.OutOfMemoryError as e:
            real = e
        torch.cuda.empty_cache()
        print(f"  (e) chaos oom_at={OBS_OOM_AT}: raised "
              f"{type(raised).__name__}: {str(raised)[:60]}...; "
              f"oom_report.json context {rep.get('context')!r}, dominant "
              f"class {rep.get('dominant_class')}, suggestion "
              f"{rep.get('suggestion')}, {len(rep.get('top_live_buffers', []))}"
              f" live buffers (largest "
              f"{rep.get('top_live_buffers', [{}])[0].get('nbytes')} bytes); "
              f"oom events {len(oom_events)}; a real over-capacity "
              f"allocation raised {type(real).__name__}, is_oom "
              f"{memory.is_oom(real) if real is not None else None}",
              flush=True)
        check(raised is not None and memory.is_oom(raised),
              f"(e) chaos oom_at raised {raised!r}")
        check(rep.get("context") == f"step-loop step {OBS_OOM_AT}" and
              rep.get("predicted") and oom_events,
              f"(e) report {rep}, oom events {oom_events}")
        check(real is not None and memory.is_oom(real),
              f"(e) the real OOM {real!r}")
        feed.close()
        del runner, state, block
    finally:
        torch.use_deterministic_algorithms(deterministic)
        for k, v in saved_knobs.items():
            _set_telemetry(**{k: v})
        from autodist_tpu_torch import autodist as autodist_mod
        autodist_mod._reset_default()
    print(f"  (f) phase 20 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# Phase 21: the rest of the in-process observability, on BERT-base serving
# and training and lm1b decode.
OBS21_REQUESTS = 32
OBS21_SLO_MS = 50
OBS21_DECODE_REQUESTS, OBS21_DECODE_TOKENS = 8, 16
OBS21_DECODE_BUCKET = (8, 256)
OBS21_PROFILED = 4
OBS21_SKEW_STEPS = 3
OBS21_SKEW_SHIFT_MS = 25.0
# rank 1's data wait in the planted run: this many times its first run's
# median step, so the wait dominates its step (the detector's flip needs
# more than half the step, the aggregate's label a third). At 1.5 the rest
# of a slept step once grew to 1.65x the first run's (PR 22: a wait of
# 960.8 of 2017.9 ms, no flip); at 3 the wait stays above half the step
# unless the rest triples.
OBS21_SLEEP_FACTOR = 3.0
OBS21_EXACT = 1e-9      # wire + skew_wait against exposed_comms
OBS21_RECONCILE = 1e-6  # the profile's sums against the ledger / trace
_ATTN_ROW = re.compile(r"^layer\d+/attn$")


def _obs21_serve_run(torch, fa, serve, cfg, params, example, requests,
                     device, label):
    """One telemetry setting's ``serve.Server`` (buckets 4 and 8, no
    coalescing wait): each bucket's allocator peak over its first
    dispatch (a full bucket straight through the replica, which warms it
    up and leaves the server's counts alone), then the traffic's answers,
    stats, dispatch log, registry snapshot, flash launches, and the run's
    phase totals and flight event kinds."""
    from autodist_tpu_torch import observability
    from autodist_tpu_torch.models import transformer as T

    def apply_fn(p, batch):
        ids, seg = batch
        return T.encode(p, cfg, ids, segment_ids=seg).float()

    t0 = time.perf_counter()
    srv = serve.Server(apply_fn, params, example, buckets=(4, 8),
                       max_wait_ms=0, device=device)
    build_s = time.perf_counter() - t0
    log = []
    inner = srv._dispatch

    def logged(group, rows):
        log.append((srv._group_bucket(group, rows)[0], rows))
        return inner(group, rows)
    srv._dispatch = logged
    answers = [None] * len(requests)
    peaks = {}
    try:
        rep = srv.engine.replicas[0]
        for b in (4, 8):
            batch = tuple(a[:1].repeat(b, 0) for a in example)
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            rep.run_bucket(rep.remapper.shard_batch(batch))
            if device == "cuda":
                torch.cuda.synchronize()
                peaks[b] = (torch.cuda.max_memory_allocated(), base)
        _flash_counts(fa, reset=True)

        def client(c):
            for i in range(c, len(requests), 4):
                answers[i] = srv.submit(requests[i]).result(timeout=300) \
                    .clone()

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), f"(a) {label}: "
              f"clients hung")
        launches = _flash_counts(fa)
        stats = srv.stats()
        snap = observability.registry().snapshot()
        phases = observability.phase_timings()
        kinds = [e["kind"] for e in observability.recorder.events()]
        engine = srv.engine
    finally:
        srv.close()
    return types.SimpleNamespace(
        answers=answers, stats=stats, log=list(log), snap=snap,
        phases=phases, kinds=kinds, launches=launches, build_s=build_s,
        engine=engine, apply_fn=apply_fn, peaks=peaks)


def _device_bytes(torch, device, peak=False):
    """The allocator's bytes in use, after a collection (what earlier
    phases dropped is freed first) and with the peak reset; with
    ``peak``, ``(in use, the peak since the last call)``, without a new
    collection. 0 off the card."""
    if device != "cuda":
        return (0, 0) if peak else 0
    torch.cuda.synchronize()
    if peak:
        return torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _obs21_serve(torch, fa, card, cfg, device, requests_n):
    """Phase 21 (a) and (b)'s serving half; returns {path: launches}."""
    from autodist_tpu_torch import observability, serve
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.observability import memory
    seq = cfg.max_len
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
    ids, seg, _, _ = bert.synthetic_batch(cfg, 8, seq, seed=0)
    example = (ids, seg)
    rng = np.random.RandomState(21)
    requests = []
    for _ in range(requests_n):
        rows = int(rng.randint(1, 9))
        requests.append((rng.randint(0, cfg.vocab, (rows, seq)).astype(
            np.int32), rng.randint(0, 2, (rows, seq)).astype(np.int32)))
    runs = {}
    for label, on in (("on", 1), ("off", 0)):
        _set_telemetry(TELEMETRY=on, SERVE_SLO_MS=OBS21_SLO_MS)
        observability.reset()
        runs[label] = _obs21_serve_run(
            torch, fa, serve, cfg, params, example, requests, device, label)
    on, off = runs["on"], runs["off"]
    peaks = on.peaks
    same = sum(torch.equal(a, b) for a, b in zip(on.answers, off.answers))
    lat = on.snap["histograms"].get("serve.latency_ms", {})
    counters, gauges = on.snap["counters"], on.snap["gauges"]
    dispatches = sum(r["dispatches"] for r in on.stats["replicas"])
    padded = sum(b - r for b, r in on.log)
    compiled = (on.phases.get("serve-aot-compile") or {}).get("count")
    print(f"  (a) serve.Server, BERT-base at seq {seq}, buckets (4, 8), "
          f"{requests_n} requests from 4 clients, no coalescing wait: "
          f"built in {on.build_s:.1f} / {off.build_s:.1f} s; answers "
          f"bitwise equal {same} of {requests_n}; p50 / p99 telemetry on "
          f"{on.stats['latency_ms']['p50']:.3f} / "
          f"{on.stats['latency_ms']['p99']:.3f} ms, off "
          f"{off.stats['latency_ms']['p50']:.3f} / "
          f"{off.stats['latency_ms']['p99']:.3f} ms; serve.requests "
          f"{counters.get('serve.requests')}, serve.latency_ms count "
          f"{lat.get('count')} p50 {lat.get('p50')} p99 {lat.get('p99')}; "
          f"serve.batches {counters.get('serve.batches')} vs dispatches "
          f"{dispatches}; serve.padded_rows "
          f"{counters.get('serve.padded_rows')} vs the log's {padded}; "
          f"serve.slo_burn {gauges.get('serve.slo_burn')}; "
          f"serve-aot-compile spans {compiled}, serve.aot_compile.ms "
          f"{gauges.get('serve.aot_compile.ms')}, "
          f"serve.replicas {gauges.get('serve.replicas')}; "
          f"flash launches "
          f"{on.launches['flash_fwd']} / {off.launches['flash_fwd']}; "
          f"telemetry off recorded {off.snap}", flush=True)
    check(same == requests_n, f"(a) {requests_n - same} answers differ "
          f"between telemetry on and off")
    check(counters.get("serve.requests") == requests_n and
          lat.get("count") == requests_n, f"(a) serve.requests "
          f"{counters.get('serve.requests')}, latency count {lat.get('count')}")
    check((lat.get("p50"), lat.get("p99")) ==
          (on.stats["latency_ms"]["p50"], on.stats["latency_ms"]["p99"]),
          f"(a) histogram p50/p99 {lat} vs stats {on.stats['latency_ms']}")
    check(counters.get("serve.batches") == dispatches == len(on.log),
          f"(a) serve.batches {counters.get('serve.batches')}, dispatches "
          f"{dispatches}, logged {len(on.log)}")
    check(counters.get("serve.padded_rows") == padded, f"(a) padded rows "
          f"{counters.get('serve.padded_rows')} vs {padded}")
    check(gauges.get("serve.slo_burn") == round(lat["p99"] / OBS21_SLO_MS, 4),
          f"(a) serve.slo_burn {gauges.get('serve.slo_burn')} vs p99 "
          f"{lat['p99']} / {OBS21_SLO_MS}")
    check(compiled == 2 and on.kinds.count("serve-compile") == 2 and
          "serve.aot_compile.ms" in gauges and
          gauges.get("serve.replicas") == 1 and
          "serve-start" in on.kinds, f"(a) bucket capture spans "
          f"{compiled}, events {on.kinds}, gauges {gauges}")
    check(off.snap == {"counters": {}, "gauges": {}, "histograms": {}},
          f"(a) telemetry off recorded {off.snap}")
    if device == "cuda":
        for label, run in runs.items():
            d = len(run.log)
            check(run.launches["flash_fwd"] == cfg.num_layers * d,
                  f"(a) telemetry {label}: flash_fwd launched "
                  f"{run.launches['flash_fwd']} times in {d} dispatches")

    # (b) the bucket memory check: a bucket the ledger's own prediction
    # puts over capacity x headroom.
    spec = serve.engine.serve_spec(None, torch.device(device))
    pred = {b: on.engine.bucket_memory(spec, (b,)) for b in (4, 8)}
    cap = pred[8]["capacity_bytes"]
    limit = cap * memory.headroom()
    slope = (pred[8].peak_bytes - pred[4].peak_bytes) / 4
    base = pred[8].peak_bytes - 8 * slope
    planted = int((limit - base) // slope) + 1
    planted_peak = on.engine.bucket_memory(spec, (planted,)).peak_bytes
    _set_telemetry(TELEMETRY=1)
    spans0 = (observability.phase_timings().get("serve-aot-compile") or
              {}).get("count", 0)
    before, refused = _device_bytes(torch, device), None
    try:
        serve.ServeEngine(on.apply_fn, params, example, (4, 8, planted),
                          device=device)
    except memory.InfeasibleMemoryError as e:
        refused = e
    after = _device_bytes(torch, device, peak=True)
    spans1 = (observability.phase_timings().get("serve-aot-compile") or
              {}).get("count", 0)
    print(f"  (b) bucket check: predicted peak 4 rows "
          f"{pred[4].peak_bytes / 2**30:.4f} GiB, 8 rows "
          f"{pred[8].peak_bytes / 2**30:.4f} GiB ({slope / 2**20:.2f} MiB a "
          f"row); capacity {cap / 2**30:.2f} GiB x headroom "
          f"{memory.headroom()} = {limit / 2**30:.2f} GiB; planted bucket "
          f"{planted} rows, predicted {planted_peak / 2**30:.3f} GiB: "
          f"{type(refused).__name__}: {str(refused)[:160]}; "
          f"memory_allocated {before} -> {after[0]} (peak during the build "
          f"{after[1]}); serve-aot-compile spans {spans0} -> {spans1}",
          flush=True)
    check(refused is not None and f"serve bucket {planted}" in str(refused),
          f"(b) the planted bucket {planted} was not refused: {refused!r}")
    check(planted_peak > limit, f"(b) the planted bucket's prediction "
          f"{planted_peak} is not above {limit}")
    check(after == (before, before) and spans1 == spans0, f"(b) the "
          f"refused build allocated (memory_allocated {before} -> "
          f"{after}, the peak during it) or captured ({spans0} -> "
          f"{spans1} spans)")
    for b, (peak, resident) in sorted(peaks.items()):
        print(f"      bucket {b}: predicted peak "
              f"{pred[b].peak_bytes / 2**30:.4f} GiB (activations "
              f"{pred[b]['activations_bytes'] / 2**30:.4f}, the (b, h, s, s)"
              f" scores the flash kernel never writes included) vs the "
              f"allocator's peak over a dispatch {peak / 2**30:.4f} GiB "
              f"({resident / 2**30:.4f} GiB resident before it: params and"
              f" the bucket graphs' pools); predicted / measured "
              f"{pred[b].peak_bytes / peak:.4f}; on {card}", flush=True)
    del params
    return {"obs21_serve_on": {"flash_fwd": on.launches["flash_fwd"],
                               "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
            "obs21_serve_off": {"flash_fwd": off.launches["flash_fwd"],
                                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}}


def _obs21_decode(torch, fa, card, cfg, device, requests_n, tokens,
                  bucket=OBS21_DECODE_BUCKET):
    """Phase 21 (b)'s decode half: a planted lane whose KV cache alone
    exceeds capacity x headroom is refused before any capture; the real
    lane decodes ``tokens`` tokens for each of ``requests_n`` requests."""
    from autodist_tpu_torch import observability, serve
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.observability import memory
    from autodist_tpu_torch.utils.tree import leaves
    params = lm.init(cfg, torch.Generator().manual_seed(0), device=device)

    def apply_fn(p, batch):
        (toks,) = batch
        return T.logits(p, cfg, T.encode(p, cfg, toks))

    def cache_bytes(slots, cache_len):
        cache = lm.init_decode_cache(cfg, slots, cache_len, device="meta")
        return float(sum(t.numel() * t.element_size()
                         for t in leaves(cache)))
    spec = serve.engine.serve_spec(None, torch.device(device))
    cap = serve.engine.bucket_memory_model(spec).topology.hbm_capacity_bytes
    limit = cap * memory.headroom()
    cache_len = cfg.max_len
    slots = int(limit // cache_bytes(1, cache_len)) + 1
    kv = cache_bytes(slots, cache_len)
    example = (np.zeros((8, 16), np.int32),)
    _set_telemetry(TELEMETRY=1, SERVE_SLO_MS=OBS21_SLO_MS)
    observability.reset()
    before, refused = _device_bytes(torch, device), None
    try:
        serve.DecodeServer(apply_fn, lm.make_decode_fn(cfg),
                           functools.partial(lm.init_decode_cache, cfg),
                           params, example, device=device,
                           buckets=(bucket, (slots, cache_len)))
    except memory.InfeasibleMemoryError as e:
        refused = e
    after = _device_bytes(torch, device, peak=True)
    spans = observability.phase_timings().get("serve-aot-compile")
    rng = np.random.RandomState(21)
    prompts = [rng.randint(1, cfg.vocab, int(rng.randint(8, 33)))
               for _ in range(requests_n)]
    _flash_counts(fa, reset=True)
    srv = serve.DecodeServer(apply_fn, lm.make_decode_fn(cfg),
                             functools.partial(lm.init_decode_cache, cfg),
                             params, example, buckets=(bucket,),
                             device=device)
    try:
        outs = [f.result(timeout=600) for f in
                [srv.submit(p, max_new_tokens=tokens) for p in prompts]]
        stats = srv.stats()
    finally:
        srv.close()
    snap = observability.registry().snapshot()
    launches = _flash_counts(fa)
    lat = snap["histograms"].get("decode.latency_ms", {})
    print(f"  (b) lm1b DecodeServer: planted lane {slots} x {cache_len}, KV "
          f"cache {kv / 2**30:.2f} GiB alone over {limit / 2**30:.2f} GiB: "
          f"{type(refused).__name__}: {str(refused)[:160]}; "
          f"memory_allocated {before} -> {after[0]} (peak during the build "
          f"{after[1]}); serve-aot-compile spans before the real lane "
          f"{spans}; the real lane "
          f"{bucket}: {stats['completed']} requests, "
          f"decode.tokens {snap['counters'].get('decode.tokens')} (= "
          f"{tokens} x {requests_n}?), decode.latency_ms count "
          f"{lat.get('count')} p50 {lat.get('p50')} p99 {lat.get('p99')}, "
          f"decode.steps {snap['counters'].get('decode.steps')}, "
          f"serve.slo_burn {snap['gauges'].get('serve.slo_burn')}; flash "
          f"launches {launches}", flush=True)
    check(refused is not None and f"decode bucket {slots}x{cache_len}" in
          str(refused), f"(b) the planted lane was not refused: {refused!r}")
    check(after == (before, before) and not spans, f"(b) the refused "
          f"decode build allocated ({before} -> {after}) or captured "
          f"({spans})")
    check(all(len(o) == tokens for o in outs) and
          snap["counters"].get("decode.tokens") == tokens * requests_n and
          snap["counters"].get("decode.requests") == requests_n and
          lat.get("count") == requests_n, f"(b) decode counts "
          f"{snap['counters']}, latency count {lat.get('count')}")
    del params
    return {"obs21_decode": launches}


def _obs21_profile(torch, fa, card, cfg, device, batch_size, seq, masked,
                   steps):
    """Phase 21 (c): the per-layer profile from ``torch.profiler``."""
    from autodist_tpu_torch import AutoDist, const, observability
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.observability import attribution, profile
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    batch = bert.synthetic_batch(cfg, batch_size, seq, masked, seed=0)
    _set_telemetry(TELEMETRY=1, TRACE="profiler")
    observability.reset()
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    runner = ad.create_distributed_session(ad.capture(
        bert.make_loss_fn(cfg),
        bert.init(cfg, torch.Generator().manual_seed(0), device=device),
        functools.partial(torch.optim.Adam, lr=1e-4), example_batch=batch))
    state = runner.create_state()
    path = os.path.join(const.DEFAULT_TRACE_DIR, "trace-rank0.json")
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    want = cfg.num_layers * steps
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        _flash_counts(fa, reset=True)
        state, _ = runner.run(state, itertools.repeat(batch), steps)
        launched = _flash_counts(fa)
        summ, attr = profile.last_profile(), attribution.last_summary()
        with open(path) as f:
            trace = json.load(f)
        kernels = [e for e in trace["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
        per = {n: {} for n in names}
        for kname, rows in (summ.get("trace") or {}).get(
                "by_kernel", {}).items():
            for n in names:
                if n + "_" in kname:
                    for row, c in rows.items():
                        per[n][row] = per[n].get(row, 0) + c
        if device != "cuda" or all(sum(per[n].values()) == want
                                   for n in names):
            break
        if not kernels:
            TIMINGS["empty"] += 1
    TIMINGS["profiles"] += attempt
    info = summ.get("trace") or {}
    trace_ms = sum(float(e.get("dur", 0.0)) for e in kernels) / 1e3 / steps
    covered = info.get("kernel_ms", 0.0) + info.get("graph_replay_ms", 0.0) \
        + info.get("comms_kernel_ms", 0.0)
    rows_sum = sum(r["compute_ms"] for r in summ["scopes"].values()) + \
        summ["unattributed"]["compute_ms"]
    known = profile.model_scope_costs(runner)[1]
    _, planted = profile.trace_scope_costs(trace, known, steps=steps,
                                           link_backward=False)
    planted_per = {n: {} for n in names}
    for kname, rows in planted["by_kernel"].items():
        for n in names:
            if n + "_" in kname:
                for row, c in rows.items():
                    planted_per[n][row] = planted_per[n].get(row, 0) + c

    def in_attn(counts):
        return all(_ATTN_ROW.match(r) for n in names for r in counts[n])
    top = [(s, round(summ["scopes"][s]["compute_ms"], 4))
           for s in summ["top"][:5]]
    print(f"  (c) profiled eager Runner.run, BERT-base MLM {batch_size} x "
          f"{seq}, {steps} steps ({attempt} profile(s)): compute source "
          f"{summ['sources'].get('compute')}; coverage "
          f"{summ['coverage_pct']}%; top 5 {top}; rows sum "
          f"{rows_sum:.6f} vs attr.device_compute_ms "
          f"{attr['device_compute_ms']:.6f}; kernel ms a step: attributed "
          f"{info.get('attributed_ms', 0):.4f} + unattributed "
          f"{info.get('unattributed_ms', 0):.4f} ({info.get('unattributed')}"
          f" units, {info.get('unlinked')} unlinked, {info.get('no_launch')}"
          f" without a launch) + graph replays "
          f"{info.get('graph_replay_ms', 0):.4f} + collectives "
          f"{info.get('comms_kernel_ms', 0):.4f} = {covered:.6f} vs the "
          f"trace's {trace_ms:.6f}; flash launches {launched}, in the trace"
          f" by row {per} (dropped by the profiler: "
          f"{ {n: want - sum(per[n].values()) for n in names} }); planted "
          f"(no backward linking): {planted_per}", flush=True)
    check(summ["sources"].get("compute") == "torch-profiler", f"(c) the "
          f"profile's source {summ['sources']}")
    # Each row is rounded to 1e-6 ms (the JAX package's reconcile).
    nrows = len(summ["scopes"]) + 1
    check(abs(rows_sum - attr["device_compute_ms"]) <= max(
        OBS21_RECONCILE * attr["device_compute_ms"], nrows * 5e-7),
          f"(c) rows sum {rows_sum} vs {attr['device_compute_ms']}")
    if info.get("mode") == "kernels":
        check(abs(covered - trace_ms) <= OBS21_RECONCILE * trace_ms,
              f"(c) attributed + unattributed {covered} vs the trace "
              f"{trace_ms}")
    if device == "cuda":
        check(launched == {n: want for n in names}, f"(c) launches "
              f"{launched}, expected {want} each")
        # Every traced flash launch in an attention row. A profile can
        # come back short of kernel events (profiled again up to
        # PROFILE_ATTEMPTS times, as phase 20 (d)); the counters hold
        # the launches themselves.
        check(all(0 < sum(per[n].values()) <= want for n in names) and
              in_attn(per), f"(c) flash launches by row {per}")
        check(not in_attn(planted_per), f"(c) the planted unlinked "
              f"attribution put every flash launch in an attention row: "
              f"{planted_per}")
    # The graph step: its capture outside the profiler (as phase 20 (b)
    # captures; the capture's dispatch is left out of the ledger, so a
    # replay follows it), then a profiled run of replays alone.
    _set_telemetry(TRACE=None)
    profile.reset()
    state, _ = runner.run(state, itertools.repeat(batch), 8, unroll=4)
    captured = (profile.last_profile() or {}).get("sources")
    _set_telemetry(TRACE="profiler")
    state, _ = runner.run(state, itertools.repeat(batch), 4, unroll=4)
    replayed = profile.last_profile()
    print(f"  (c) unroll=4: the capture run (not profiled) took the "
          f"profile source {captured}; the profiled replay run "
          f"{replayed['sources']} ("
          f"{(replayed.get('trace') or {}).get('graph_replay_kernels')} "
          f"kernels under graph launches)", flush=True)
    _set_telemetry(TRACE=None)
    del runner, state
    autodist_mod._reset_default()
    return {"obs21_profile": launched}


def obs_skew_rank(rank, world, port, spec):
    """One rank of phase 21 (d): a gloo world over ``localhost`` on
    device 0 trains BERT-base MLM on ``{data: 2}`` (``AllReduce()``, Adam
    1e-4) twice through ``Runner.run``, the second time with rank 1's data
    iterator sleeping; rank 0 serves the monitor on ``spec["port"]`` and
    scrapes it. Prints {ring indices, runs' flash launches, the chief's
    skew summary, aggregate, anomalies, events, endpoints, the planted
    clock shift's estimate}. Then (phase 22 (b), (c)) both ranks record
    ``spec["syncs"]`` matched ``sync`` spans, each around a barrier, and
    rank 0 alone writes the step text and the transform report while rank
    1 waits at a barrier; the trace is flushed with the true clock
    estimate (the planted shift undone). ``spec["workdir"]`` (when set)
    is the ranks' ``AUTODIST_WORKING_DIR``."""
    import datetime
    import urllib.request
    spec = json.loads(spec)
    if spec.get("workdir"):
        os.environ["AUTODIST_WORKING_DIR"] = spec["workdir"]
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import AutoDist, observability
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.observability import cluster, monitor, skew
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    device = spec["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    os.environ["AUTODIST_TELEMETRY"] = "1"
    for knob in ("AUTODIST_TRACE", "AUTODIST_SKEW_RING",
                 "AUTODIST_CLOCK_SYNC"):
        os.environ.pop(knob, None)
    if rank == 0:
        os.environ["AUTODIST_MONITOR_PORT"] = str(spec["monitor_port"])
    observability.refresh()
    cfg = T.TransformerConfig(**dict(spec["config"], dtype=getattr(
        torch, spec["dtype"])))
    full = bert.synthetic_batch(cfg, spec["batch"], spec["seq"],
                                spec["masked"], seed=0)
    local = spec["batch"] // world
    mine = tuple(a[rank * local:(rank + 1) * local] for a in full)
    ad = AutoDist(strategy_builder=AllReduce(), device=device)
    runner = ad.create_distributed_session(ad.capture(
        bert.make_loss_fn(cfg),
        bert.init(cfg, torch.Generator().manual_seed(0), device=device),
        functools.partial(torch.optim.Adam, lr=1e-4), example_batch=mine))
    state = runner.create_state()
    out = {"rank": rank, "launches": [], "step_p50": [], "wait_p50": []}
    sleep_s = 0.0

    def batches():
        while True:
            if sleep_s:
                time.sleep(sleep_s)
            yield mine
    for run in range(2):
        observability.registry().reset()
        _flash_counts(fa, reset=True)
        state, _ = runner.run(state, batches(), spec["steps"])
        out["launches"].append(_flash_counts(fa))
        hists = observability.registry().snapshot()["histograms"]
        out["step_p50"].append(hists["step.latency_ms"]["p50"])
        out["wait_p50"].append(hists["step.data_wait_ms"]["p50"])
        if rank == 0:
            out.setdefault("summaries", []).append(skew.last_summary())
            out.setdefault("aggregate", []).append(
                cluster.aggregate(cluster.gathered()))
        if rank == 1:  # the planted straggler: a slow input pipeline
            sleep_s = spec["sleep_factor"] * out["step_p50"][0] / 1e3
        out["sleep_s"] = sleep_s
    out["ring"] = [r["i"] for r in skew.ring()]
    out["offset"] = skew.local_offset()
    # The planted clock shift, on one more exchange.
    wall = skew._wall
    if rank == 1:
        skew._wall = lambda: time.time() + spec["shift_ms"] / 1e3
    shifted = skew.maybe_sync_clocks()
    if rank == 1:  # the true clock again, for the trace flushed below
        skew._wall, skew._local_offset = wall, out["offset"]
    if rank == 0:
        out["shifted"] = shifted
        out["anomalies"] = monitor.detector().anomalies()
        out["events"] = [(e["kind"], e.get("detail"), e.get("kind_detail"))
                         for e in observability.recorder.events()
                         if e["kind"] in ("anomaly", "straggler")]
        url = f"http://127.0.0.1:{monitor.port()}"
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            out["metrics"] = r.read().decode("utf-8")
        with urllib.request.urlopen(url + "/status", timeout=30) as r:
            out["status"] = json.loads(r.read().decode("utf-8"))
        port_was = monitor.port()
        monitor.stop()
        import socket
        with socket.socket() as sock:
            # As an HTTP server binds (the scrapes' TIME_WAIT aside).
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                sock.bind(("0.0.0.0", port_was))
                sock.listen(1)
                out["port_freed"] = True
            except OSError:
                out["port_freed"] = False
    # Phase 22 (c): matched spans, each ending as its barrier releases both
    # (after one bare barrier: the ranks arrive here seconds apart).
    dist.barrier()
    for j in range(spec.get("syncs", 0)):
        with observability.span("sync", i=j):
            dist.barrier()
    # Phase 22 (b): the chief alone writes the step text and the report.
    if rank == 0:
        flash = _flash_counts(fa)
        t0 = time.perf_counter()
        text = runner._step_text(mine)
        t1 = time.perf_counter()
        path = runner.write_report(mine)
        out["report"] = {
            "text_ms": (t1 - t0) * 1e3,
            "write_ms": (time.perf_counter() - t1) * 1e3,
            "all_reduce": len(re.findall(r"\ball-reduce\(", text)),
            "grad_sync_all_reduce": _grad_sync_all_reduces(text),
            "buckets": len(runner.bucket_plan()),
            "page": os.path.basename(path),
            "flash_moved": _flash_counts(fa) != flash}
    t0 = time.perf_counter()
    dist.barrier()
    out["report_wait_s"] = time.perf_counter() - t0
    out["trace"] = observability.flush_trace()
    out["pid"] = os.getpid()
    del runner, state
    dist.destroy_process_group()
    print(json.dumps(out, default=str), flush=True)
    return 0


def _grad_sync_all_reduces(text):
    """The gradient sync's all-reduces in a step text (phase 22)."""
    return len(re.findall(r"\ball-reduce\([^\n]*phase=grad-sync", text))


_PROM_LINE = re.compile(
    r"^(#\s(HELP|TYPE)\s.*|[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[^}]*\})?\s[-+0-9.eE]+)$")   # one Prometheus exposition line
OBS21_STATUS = ("time", "hosts_reporting", "run", "step", "attribution",
                "profile", "pipeline", "skew", "memory", "goodput", "hosts",
                "serve", "decode", "warnings", "anomalies")


def _obs21_skew(torch, fa, card, cfg, device, batch_size, seq, masked,
                steps, share=None):
    """Phase 21 (d): two gloo ranks, skew, the aggregate and the monitor;
    their working directory and results go to ``share["obs21"]`` for
    phase 22."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        monitor_port = sock.getsockname()[1]
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = json.dumps({
        "device": device, "config": fields,
        "dtype": str(cfg.dtype).split(".")[-1], "batch": batch_size,
        "seq": seq, "masked": masked, "steps": steps,
        "monitor_port": monitor_port, "shift_ms": OBS21_SKEW_SHIFT_MS,
        "sleep_factor": OBS21_SLEEP_FACTOR, "syncs": OBS22_SYNCS,
        "workdir": os.path.join(share["dir"], "obs21_ranks")
        if share else None})
    r0, r1 = _spawn_ranks(2, "--obs-skew", spec, "phase 21 (d) rank")
    if share is not None:
        share["obs21"] = {"dir": os.path.join(share["dir"], "obs21_ranks"),
                          "ranks": (r0, r1)}
    first, planted = r0["summaries"]
    agg = r0["aggregate"][1]
    agg["hosts"] = {int(h): i for h, i in agg["hosts"].items()}
    est = {int(h): row for h, row in planted["hosts"].items()}
    shifted = {int(h): v for h, v in (r0.get("shifted") or {}).items()}
    lines = [l for l in r0["metrics"].splitlines() if l.strip()]
    bad = [l for l in lines if not _PROM_LINE.match(l)]
    status = r0["status"]
    split = [abs(w["wire_ms"] + w["skew_wait_ms"] - w["exposed_comms_ms"])
             for summ in (first, planted)
             for row in summ["hosts"].values() for w in row["windows"]]
    split += [abs(row["wire_ms"] + row["skew_wait_ms"] -
                  row["exposed_comms_ms"])
              for summ in (first, planted) for row in summ["hosts"].values()]
    flips = [e for e in r0["events"] if e[2] == "input-bound-flip"]
    print(f"  (d) two gloo ranks, BERT-base MLM {batch_size} x {seq} on "
          f"{{data: 2}}, {steps} steps a run: step p50 rank 0 "
          f"{r0['step_p50']}, rank 1 {r1['step_p50']} ms; data wait p50 "
          f"rank 1 {r1['wait_p50']} ms (sleeping {r1['sleep_s']:.3f} s a "
          f"batch in the second run); rings {r0['ring']} / {r1['ring']}; "
          f"rank 1's clock offset {est[1]['offset_ms']} ms +- "
          f"{est[1]['uncertainty_ms']} ms (drift {est[1]['drift_ppm']} "
          f"ppm); the planted +{OBS21_SKEW_SHIFT_MS} ms reads "
          f"{shifted.get(1)}; max |wire + skew_wait - exposed| "
          f"{max(split):.3e} over {len(split)} rows and windows", flush=True)
    print(f"      straggler verdict (planted run): {planted['straggler']}, "
          f"significant {planted['significant']}, max skew wait "
          f"{planted['max_skew_wait_ms']} ms, per rank "
          f"{ {h: (r['skew_wait_ms'], r['wire_ms'], r['exposed_comms_ms'], r['exposed_comms_source']) for h, r in est.items()} }"
          f" (skew_wait, wire, exposed ms a step; exposed_comms is the cost "
          f"model's estimate, the same on both ranks, so the split cannot "
          f"exceed it); aggregate labels "
          f"{ {h: i['bound'] for h, i in agg['hosts'].items()} }, warnings "
          f"{agg['warnings']}; anomaly events {r0['events']}; /metrics "
          f"{len(lines)} lines ({len(bad)} unparsed), /status sections "
          f"{sorted(status)}; port freed {r0['port_freed']}; flash "
          f"launches {r0['launches']} / {r1['launches']}", flush=True)
    check(abs(est[1]["offset_ms"]) <= est[1]["uncertainty_ms"] + 1e-9,
          f"(d) one host, yet rank 1's offset {est[1]}")
    check(1 in shifted and abs(shifted[1]["offset_ms"] - OBS21_SKEW_SHIFT_MS)
          <= shifted[1]["uncertainty_ms"] + 1e-9, f"(d) the planted shift "
          f"of {OBS21_SKEW_SHIFT_MS} ms read {shifted.get(1)}")
    check(r0["ring"] == r1["ring"] and planted["windows"] ==
          len(r0["ring"]) == 2 * steps, f"(d) rings {r0['ring']} / "
          f"{r1['ring']}, {planted['windows']} windows")
    check(max(split) <= OBS21_EXACT, f"(d) wire + skew_wait differs from "
          f"exposed_comms by {max(split)}")
    check(agg["hosts"][1]["bound"] == "input" and
          agg["hosts"][0]["bound"] == "compute",
          f"(d) aggregate labels {agg['hosts']}")
    check(len(flips) == 1 and "host 1" in flips[0][1], f"(d) input-bound "
          f"flip events {r0['events']}")
    check(not bad and "autodist_step_latency_ms_count" in r0["metrics"] and
          "autodist_skew_wait_ms_per_step" in r0["metrics"] and
          "autodist_host_skew_wait_ms" in r0["metrics"],
          f"(d) /metrics: unparsed {bad[:3]}")
    check(set(OBS21_STATUS) <= set(status) and status["skew"]["windows"]
          == 2 * steps, f"(d) /status sections {sorted(status)}")
    check(r0["port_freed"], "(d) monitor.stop() left the port bound")
    if device == "cuda":
        for r in (r0, r1):
            for run in r["launches"]:
                check(run == {n: cfg.num_layers * steps for n in run},
                      f"(d) rank {r['rank']} launches {run}")
    return {f"obs21_skew_rank{r['rank']}": {
        n: sum(run[n] for run in r["launches"]) for n in r["launches"][0]}
        for r in (r0, r1)}


def obs21_phase(torch, fa, card, device, serve_cfg, train_cfg, lm_cfg,
                requests=OBS21_REQUESTS, batch_size=32, seq=128, masked=20,
                profiled=OBS21_PROFILED, skew_steps=OBS21_SKEW_STEPS,
                decode_requests=OBS21_DECODE_REQUESTS,
                decode_tokens=OBS21_DECODE_TOKENS,
                decode_bucket=OBS21_DECODE_BUCKET, share=None):
    """Phase 21; returns {path: flash launches}. With ``share`` (a dict
    holding a scratch ``"dir"``) (d)'s ranks write there, and
    ``share["obs21"]`` keeps their directory and results for phase 22."""
    t_phase = time.perf_counter()
    print(f"phase 21: the rest of the in-process observability: serving "
          f"telemetry and the bucket memory check (BERT-base at seq "
          f"{serve_cfg.max_len}, lm1b decode), the per-layer profile and "
          f"the skew split, aggregate and monitor (BERT-base MLM "
          f"{batch_size} x {seq})", flush=True)
    saved = {k: os.environ.get(f"AUTODIST_{k}")
             for k in ("TELEMETRY", "TRACE", "SERVE_SLO_MS")}
    out = {}
    try:
        out.update(_obs21_serve(torch, fa, card, serve_cfg, device,
                                requests))
        out.update(_obs21_decode(torch, fa, card, lm_cfg, device,
                                 decode_requests, decode_tokens,
                                 decode_bucket))
        out.update(_obs21_profile(torch, fa, card, train_cfg, device,
                                  batch_size, seq, masked, profiled))
        out.update(_obs21_skew(torch, fa, card, train_cfg, device,
                               batch_size, seq, masked, skew_steps, share))
    finally:
        for k, v in saved.items():
            _set_telemetry(**{k: v})
        from autodist_tpu_torch import autodist as autodist_mod
        autodist_mod._reset_default()
        if device == "cuda":
            torch.cuda.empty_cache()
    print(f"  (e) phase 21 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# Phase 22: the transform report, the step's op text and the merged
# cluster timeline, on BERT-base training.
OBS22_STEPS = 4          # one unroll=4 block
OBS22_UNROLL = 4
OBS22_SYNCS = 3          # matched sync spans each phase 21 (d) rank records
OBS22_BARRIER_MS = 1.0   # a barrier's exit spread across the two ranks
OBS22_PHASE_S = 40.0


def _obs22_state(runner, state):
    """Copies of what a step updates: params, optimizer state, the step
    count, and every graph step's static batch buffers."""
    from autodist_tpu_torch.utils.tree import leaves
    out = [t.detach().clone() for t in leaves(state.params)]
    out += [v.clone() for _, t in runner._update_tensors(state)
            for v in state.opt_state.state.get(t, {}).values()]
    out.append(state.step.clone())
    for graph in runner._graphs.values():
        out += [t.clone() for t in graph._static]
    return out


def _page_figures(page):
    """Phase 22 (a): the page's attribution, goodput and memory figures
    against the ledgers' own values at the page's rounding; returns the
    figures that are missing from the page."""
    from autodist_tpu_torch import report
    from autodist_tpu_torch.observability import attribution, goodput, memory
    attr = attribution.last_summary() or {}
    good = goodput.last_summary() or {}
    mem = memory.last_summary() or {}
    want = [f"<td>{report._fmt_ms(attr.get(c))}</td>"
            for c in ("wall_ms",) + attribution.COMPONENTS[:-1]]
    want.append(f"goodput <b>{good.get('goodput_pct') or 0:.1f}%</b>")
    want.append(f"predicted peak <b>{mem.get('predicted_peak_gb', 0):.3f}"
                f" GiB</b>")
    return [w for w in want if w not in page] + \
        (["attribution summary"] if not attr else []) + \
        (["goodput summary"] if not good else []) + \
        (["memory summary"] if not mem else [])


def _obs22_report(torch, fa, card, cfg, device, batch_size, seq, masked,
                  graphs):
    """Phase 22 (a); returns the run's flash launches."""
    from autodist_tpu_torch import AutoDist, const, report
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    const.DEFAULT_GRAPH_DUMP_DIR = graphs
    batch = bert.synthetic_batch(cfg, batch_size, seq, masked, seed=0)

    def session(dev):
        autodist_mod._reset_default()
        ad = AutoDist(strategy_builder=AllReduce(), device=dev)
        return ad.create_distributed_session(ad.capture(
            bert.make_loss_fn(cfg),
            bert.init(cfg, torch.Generator().manual_seed(0), device=dev),
            functools.partial(torch.optim.Adam, lr=1e-4),
            example_batch=batch))
    runner = session(device)
    state = runner.create_state()
    _flash_counts(fa, reset=True)
    state, metrics = runner.run(state, itertools.repeat(batch), OBS22_STEPS,
                                unroll=OBS22_UNROLL)
    loss = float(metrics["loss"][-1])
    launched = _flash_counts(fa)
    auto = sorted(os.listdir(graphs))
    t0 = time.perf_counter()
    report.render_report(runner.program, execution="CUDA graph")
    render_ms = (time.perf_counter() - t0) * 1e3
    before = _obs22_state(runner, state)
    flash = _flash_counts(fa)
    t0 = time.perf_counter()
    path = runner.write_report(batch)
    write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dump = runner.dump_compiled(batch)
    dump_ms = (time.perf_counter() - t0) * 1e3
    after = _obs22_state(runner, state)
    moved = {k: v - flash[k] for k, v in _flash_counts(fa).items()}
    unchanged = len(before) == len(after) and all(
        torch.equal(a, b) for a, b in zip(before, after))
    with open(path) as f:
        page = f.read()
    with open(os.path.join(graphs, "report.html")) as f:
        alias = f.read()
    with open(dump) as f:
        text = f.read()
    item = runner.program.graph_item
    capture = (f"<p>{len(item.variables)} variables ·\n"
               f"{sum(v.size_bytes for v in item.variables):,} bytes ·")
    lines = {k: text.count(f'custom_call_target="{k}"') for k in flash}
    missing = _page_figures(page)
    del runner, state, before, after
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_text = session("cpu")._step_text(batch)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    autodist_mod._reset_default()
    print(f"  (a) BERT-base MLM {batch_size} x {seq}, {OBS22_STEPS} steps of "
          f"unroll={OBS22_UNROLL} (loss {loss:.4f}, flash launches "
          f"{launched}); the capture rendered "
          f"{auto}; render {render_ms:.1f} ms, write_report {write_ms:.1f} "
          f"ms, dump_compiled {dump_ms:.1f} ms ({card}); step text "
          f"{len(text.splitlines())} ops, {len(text)} chars, flash lines "
          f"{lines}, collectives {report.collective_summary(text)}; the "
          f"same program's step text on the CPU ({cpu_ms:.0f} ms with its "
          f"capture) equal: {cpu_text == text}; state unchanged "
          f"{unchanged}, flash launches moved {moved}; page figures "
          f"missing {missing}", flush=True)
    check(device != "cuda" or launched == {
        k: cfg.num_layers * OBS22_STEPS for k in launched},
        f"(a) the run's flash launches {launched}")
    check(len(auto) == 2 and "report.html" in auto,
          f"(a) the graph capture rendered {auto}")
    check(page == alias, "(a) the page and its report.html alias differ")
    check(capture in page, f"(a) the page's capture line lacks {capture!r}")
    check(unchanged, "(a) write_report / dump_compiled changed the state")
    check(not any(moved.values()), f"(a) flash launches moved {moved}")
    check(lines == {k: cfg.num_layers for k in flash},
          f"(a) the step text's flash lines {lines}")
    check(cpu_text == text, "(a) the step text differs on the CPU")
    check(not missing, f"(a) the page lacks the ledgers' {missing}")
    return launched


def _counts_agree(report_counts, buckets):
    """Phase 22 (b)'s check: the gradient sync's all-reduces are the
    bucket plan's, and the loss's mean is the one other."""
    return (report_counts["grad_sync_all_reduce"] == buckets and
            report_counts["all_reduce"] == buckets + 1)


def _sync_gaps(doc):
    """ms between the two hosts' ends of each matched ``sync`` span of a
    merged timeline."""
    ends = {}
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"] == "sync":
            ends.setdefault(e["args"]["i"], {})[e["pid"]] = e["ts"] + e["dur"]
    return [abs(v[0] - v[1]) / 1e3 for _, v in sorted(ends.items())
            if set(v) == {0, 1}]


def _plant_shift(src, dst, rank1_pid, shift_ms, offset_ms):
    """A copy of the two ranks' directory as if rank 1's clock ran
    ``shift_ms`` ahead (its trace anchor and flight times moved), its
    trace stamped with ``offset_ms`` as its clock offset."""
    shutil.copytree(src, dst)
    trace = os.path.join(dst, "traces", f"autodist_trace_{rank1_pid}.json")
    with open(trace) as f:
        doc = json.load(f)
    doc["metadata"]["epoch_anchor_us"] += shift_ms * 1e3
    doc["metadata"]["clock_offset_ms"] = offset_ms
    with open(trace, "w") as f:
        json.dump(doc, f)
    for path in glob.glob(os.path.join(dst, "logs",
                                       f"flight_{rank1_pid}*.jsonl")):
        with open(path) as f:
            events = [json.loads(line) for line in f if line.strip()]
        with open(path, "w") as f:
            for e in events:
                e["t"] = e["t"] + shift_ms / 1e3
                f.write(json.dumps(e) + "\n")


def _obs22_merge(card, obs21):
    """Phase 22 (b) and (c), over phase 21 (d)'s ranks."""
    from autodist_tpu_torch.tools import timeline
    r0, r1 = obs21["ranks"]
    rep = r0["report"]
    print(f"  (b) rank 0 alone: step text {rep['text_ms']:.1f} ms, "
          f"write_report {rep['write_ms']:.1f} ms ({card}); rank 1 waited "
          f"{r1['report_wait_s']:.3f} s at its barrier; all-reduces "
          f"{rep['all_reduce']} ({rep['grad_sync_all_reduce']} in the "
          f"gradient sync), bucket_plan() {rep['buckets']}; flash launches "
          f"moved {rep['flash_moved']}", flush=True)
    check(_counts_agree(rep, rep["buckets"]), f"(b) step text counts {rep}")
    check(not _counts_agree(rep, rep["buckets"] + 1),
          "(b) the planted fault (a bucket plan one longer) passed")
    check(not rep["flash_moved"], "(b) the step text launched a kernel")
    check(r1["report_wait_s"] >= 0.5 * (rep["text_ms"] + rep["write_ms"])
          / 1e3, f"(b) rank 1 waited {r1['report_wait_s']} s")
    root = obs21["dir"]
    t0 = time.perf_counter()
    doc = timeline.merge(root)
    merge_ms = (time.perf_counter() - t0) * 1e3
    by_host = {}
    for path in sorted(glob.glob(os.path.join(root, "traces", "*.json"))):
        with open(path) as f:
            src = json.load(f)
        by_host[src["metadata"]["host"]] = sorted(
            (e["name"], e["dur"]) for e in src["traceEvents"]
            if e.get("ph") == "X")
    merged = {h: sorted((e["name"], e["dur"]) for e in doc["traceEvents"]
                        if e.get("ph") == "X" and e["pid"] == h and
                        e.get("cat") != "skew") for h in by_host}
    true = {int(h): v for h, v in r0["summaries"][1]["hosts"].items()}
    est = {int(h): v for h, v in (r0.get("shifted") or {}).items()}[1]
    gaps = _sync_gaps(doc)
    tol_true = true[1]["uncertainty_ms"] + OBS22_BARRIER_MS
    tol = est["uncertainty_ms"] + OBS22_BARRIER_MS
    planted = os.path.join(root + "_planted")
    zeroed = os.path.join(root + "_zeroed")
    _plant_shift(root, planted, r1["pid"], OBS21_SKEW_SHIFT_MS,
                 est["offset_ms"])
    _plant_shift(root, zeroed, r1["pid"], OBS21_SKEW_SHIFT_MS, 0.0)
    planted_gaps = _sync_gaps(timeline.merge(planted))
    zeroed_gaps = _sync_gaps(timeline.merge(zeroed))
    shutil.rmtree(planted, ignore_errors=True)
    shutil.rmtree(zeroed, ignore_errors=True)
    print(f"  (c) merged {len(doc['traceEvents'])} events of hosts "
          f"{doc['metadata']['hosts']} in {merge_ms:.1f} ms ({card}); spans "
          f"a host {[len(v) for v in by_host.values()]}; sync span gaps "
          f"{[round(g, 4) for g in gaps]} ms (tolerance {tol_true:.4f}); "
          f"rank 1 planted {OBS21_SKEW_SHIFT_MS} ms ahead, estimated "
          f"{est['offset_ms']:.4f} +- {est['uncertainty_ms']:.4f} ms: gaps "
          f"{[round(g, 4) for g in planted_gaps]} ms (tolerance {tol:.4f}); "
          f"offset zeroed: {[round(g, 4) for g in zeroed_gaps]} ms",
          flush=True)
    check(set(by_host) == {0, 1} and merged == by_host,
          f"(c) spans lost or doubled in the merge: {len(by_host)} traces")
    check(len(gaps) == len(planted_gaps) == OBS22_SYNCS,
          f"(c) matched sync spans {gaps} / {planted_gaps}")
    check(max(gaps) <= tol_true, f"(c) sync spans {gaps} ms apart")
    check(max(planted_gaps) <= tol, f"(c) with the planted shift "
          f"corrected the sync spans sit {planted_gaps} ms apart")
    check(not max(zeroed_gaps) <= tol, f"(c) the planted fault (offset "
          f"zeroed) passed: {zeroed_gaps} ms")


def obs22_phase(torch, fa, card, device, cfg, share, batch_size=32, seq=128,
                masked=20):
    """Phase 22: (a) on a BERT ``cfg`` Runner here, (b) and (c) over phase
    21 (d)'s ranks (``share["obs21"]``); returns {path: flash launches}
    of (a)'s run."""
    t_phase = time.perf_counter()
    print(f"phase 22: the transform report, the step's op text and the "
          f"merged cluster timeline; BERT-base MLM {batch_size} x {seq}",
          flush=True)
    saved = {k: os.environ.get(f"AUTODIST_{k}")
             for k in ("TELEMETRY", "TRACE")}
    from autodist_tpu_torch import const
    graphs_was = const.DEFAULT_GRAPH_DUMP_DIR
    graphs = os.path.join(share["dir"], "obs22_graphs")
    os.makedirs(graphs, exist_ok=True)
    try:
        _set_telemetry(TELEMETRY=1, TRACE=None)
        launched = _obs22_report(torch, fa, card, cfg, device, batch_size,
                                 seq, masked, graphs)
        _obs22_merge(card, share["obs21"])
    finally:
        const.DEFAULT_GRAPH_DUMP_DIR = graphs_was
        for k, v in saved.items():
            _set_telemetry(**{k: v})
        from autodist_tpu_torch import autodist as autodist_mod
        autodist_mod._reset_default()
    took = time.perf_counter() - t_phase
    print(f"  (d) phase 22 took {took:.1f} s", flush=True)
    check(took <= OBS22_PHASE_S or device != "cuda",
          f"(d) phase 22 took {took:.1f} s, over {OBS22_PHASE_S} s")
    return {"obs22_report": launched}


# Phase 23: the multi-process runtime. ``--elastic-train`` is the user
# script the Coordinator re-runs: generation 0's chief and worker, the
# re-exec'd generation 1, and the control arm are each this script.
ELASTIC_TOTAL = 12      # steps: generation 1 replays its graph once
ELASTIC_CRASH = 3       # kill_at=3:1: the worker dies after step 3
ELASTIC_SAVE_EVERY = 2  # generation 0's checkpoints: steps 1 and 2
ELASTIC_UNROLL = 4
ELASTIC_KINDS = ("worker-death", "re-form-request", "re-form", "spec-shrink",
                 "reshard", "emergency-save")
ELASTIC_RECONCILE = 0.05  # goodput + classes vs the stitched wall
ELASTIC_PHASE_S = 180     # a hung generation fails the phase
ELASTIC_CHILD_S = 300


def _elastic_spec(path, nodes, port=None):
    lines = ([f"launch: local", f'coordinator: "127.0.0.1:{port}"']
             if port is not None else []) + ["nodes:"]
    for i, node in enumerate(nodes):
        lines += [f"  - address: {node}"] + (["    chief: true"] if i == 0
                                             else []) + ["    gpus: [0]"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _elastic_dump(path, record):
    with open(path + ".tmp", "w") as f:
        json.dump(record, f)
    os.replace(path + ".tmp", path)


def elastic_train_child(spec_path, directory, out_dir, knobs):
    """Phase 23's user script. Generation 0 (a ``launch: local`` spec, no
    ``AUTODIST_ELASTIC_WORLD``): the chief's ``AutoDist`` launches the
    worker (this script again), both train their 16 rows a step through
    ``CheckpointManager.run(coordinator=...)``; the worker records its
    flash launches as chaos kills it, the chief as its coordinator
    re-execs it (the ``_exec`` hook). Generation 1 (the re-exec) and the
    control arm: one process resumes the newest checkpoint and runs to
    ``total`` on the whole batch, then writes its params, launches,
    restore times and report page."""
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import AutoDist, observability, report
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.checkpoint.manifest import state_tree
    from autodist_tpu_torch.checkpoint.saver import write_tree
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    from autodist_tpu_torch.resilience import chaos
    from autodist_tpu_torch.strategy import AllReduce
    t_start = time.perf_counter()
    knobs = json.loads(knobs)
    device = knobs["device"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    cfg = T.TransformerConfig(**dict(knobs["config"], dtype=getattr(
        torch, knobs["dtype"])))
    (batch,) = weighted_batches(cfg, [0], knobs["batch"], knobs["seq"],
                                knobs["masked"])
    gen = int(os.environ.get("AUTODIST_RUN_GENERATION", "0") or 0)
    resumed = bool(int(os.environ.get("AUTODIST_ELASTIC_WORLD", "0") or 0))
    arm = knobs.get("arm", "elastic")
    ad = AutoDist(resource_spec_file=spec_path, strategy_builder=AllReduce(),
                  device=device)
    runner = ad.create_distributed_session(ad.capture(
        weighted_mlm_loss(cfg), bert_init(torch, cfg, device),
        functools.partial(torch.optim.Adam, lr=1e-4), example_batch=batch))
    rank, world = dist.get_rank(), dist.get_world_size()
    backend = dist.get_backend()
    _flash_counts(fa, reset=True)  # the main path of this generation
    if resumed or arm != "elastic":
        check(world == 1, f"phase 23: the continuation has {world} ranks")
        if knobs.get("after"):  # the control arm starts with (a)'s job
            deadline = time.monotonic() + ELASTIC_CHILD_S
            while not os.path.exists(knobs["after"]):
                check(time.monotonic() < deadline, "phase 23 (b): generation "
                      "0 never re-exec'd")
                time.sleep(0.1)
        mgr = CheckpointManager(runner, directory, save_interval_steps=10 ** 9)
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        state = mgr.restore_or_init()
        if device == "cuda":
            torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
        start = int(state.step)
        dbatch = runner.remapper.shard_batch(batch)
        state, metrics = mgr.run(state, iter(lambda: dbatch, None),
                                 knobs["total"], unroll=knobs["unroll"])
        launches = _flash_counts(fa)
        graph = next(iter(runner._graphs.values())).graph \
            if runner._graphs else None
        params = state_tree(runner.to_logical(state))["params"]
        name = f"{arm}-g{gen}"
        write_tree(os.path.join(out_dir, f"{name}-params"),
                   {k: t.detach().cpu() for k, t in
                    flatten_params(params).items()})
        snap = observability.registry().snapshot() \
            if observability.enabled() else {}
        page = report.render_report(
            runner.program, out_path=os.path.join(out_dir, f"{name}.html"))
        _elastic_dump(os.path.join(out_dir, f"{name}.json"), {
            "rank": rank, "world": world, "backend": backend,
            "generation": gen, "start": start, "step": int(state.step),
            "loss": [float(x) for x in
                     torch.as_tensor(metrics["loss"]).reshape(-1)],
            "launches": launches, "restore_ms": restore_ms,
            "reshard_ms": (snap.get("gauges") or {}).get(
                "checkpoint.reshard_ms"),
            "replays": graph.replays if graph is not None else None,
            "captured": bool(graph is not None and graph.captured),
            "page": page, "seconds": time.perf_counter() - t_start})
        mgr.close()
        return 0

    # Generation 0: each rank's rows; the launches each rank made by its
    # last step that returned are kept where it leaves the run.
    per = knobs["batch"] // world
    mine = tuple(torch.as_tensor(a[rank * per:(rank + 1) * per]).to(device)
                 for a in batch)
    completed = {"steps": 0, "launches": _flash_counts(fa)}
    step = runner.step

    def counted(*args, **kwargs):
        out = step(*args, **kwargs)
        completed["steps"] += 1
        completed["launches"] = _flash_counts(fa)
        return out
    runner.step = counted

    def dump(why):
        _elastic_dump(os.path.join(out_dir, f"elastic-g0-r{rank}.json"), {
            "rank": rank, "world": world, "backend": backend,
            "generation": gen, "why": why,
            "completed_steps": completed["steps"],
            "launches": completed["launches"], "dispatched": _flash_counts(fa),
            "seconds": time.perf_counter() - t_start})

    record = chaos._record

    def killed(kind, detail):  # the worker's last word before os._exit(9)
        record(kind, detail)
        if kind == "chaos:kill":
            dump("chaos:kill")
    chaos._record = killed
    coordinator = ad.coordinator
    if coordinator is not None:
        execve = coordinator._exec

        def reexec(path, argv, env):  # the chief's last word before exec
            dump("re-exec")
            execve(path, argv, env)
        coordinator._exec = reexec
    mgr = CheckpointManager(runner, directory,
                            save_interval_steps=ELASTIC_SAVE_EVERY)
    state = mgr.restore_or_init()
    check(int(state.step) == 0, "phase 23: generation 0 must start fresh")
    mgr.run(state, iter(lambda: mine, None), knobs["total"],
            coordinator=coordinator)
    print(f"phase 23: generation 0 rank {rank} ran to its end", flush=True)
    return 3  # neither rank gets here: a death or a re-exec ends them


def bert_init(torch, cfg, device):
    from autodist_tpu_torch.models import bert
    return bert.init(cfg, torch.Generator().manual_seed(0), device=device)


def _elastic_start(label, argv, env, directory):
    """Start one phase-23 job (this script, ``--elastic-train``), its
    output to ``<label>.log``. The job stays in this process's group, so a
    signal that ends this script's group ends it too, and this process
    adopts what the job leaves behind (:func:`adopt_orphans`)."""
    adopt_orphans()
    with open(os.path.join(directory, f"{label}.log"), "w") as f:
        proc = subprocess.Popen(argv, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    proc.label, proc.log, proc.t0 = label, f.name, time.perf_counter()
    return proc


def _elastic_finish(proc, timeout=ELASTIC_CHILD_S, spare=()):
    """Wait for a job of :func:`_elastic_start`; returns (seconds,
    output). Fails the phase if it fails, outlives ``timeout``, or leaves
    a process running after its chief exits (each is killed first; the
    jobs in ``spare`` run on)."""
    try:
        code = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        code = None
    finally:
        if proc.poll() is None:
            stop_descendants(proc.pid)
            proc.kill()
        proc.wait()
        left = stop_descendants(spare=[p.pid for p in spare])
    with open(proc.log) as f:
        text = f.read()
    check(code == 0, f"phase 23 ({proc.label}) exited with {code}: "
          f"{text[-4000:]}")
    check(not left, f"phase 23 ({proc.label}) left processes running after "
          f"its chief exited (killed): {left}")
    return time.perf_counter() - proc.t0, text


def _elastic_events(log_dir):
    """(kind, detail) of every flight-file event under ``log_dir``."""
    out = []
    for path in sorted(glob.glob(os.path.join(log_dir, "flight_*.jsonl"))):
        with open(path) as f:
            for line in f:
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                out.append((e.get("kind"), e.get("detail", "")))
    return out


def elastic_phase(torch, fa, card, cfg, device, directory, batch_size=32,
                  seq=128, masked=20, total=ELASTIC_TOTAL,
                  crash=ELASTIC_CRASH, unroll=ELASTIC_UNROLL):
    """Phase 23; returns {path: flash launches}."""
    import socket
    from autodist_tpu_torch import report
    from autodist_tpu_torch.checkpoint.saver import read_tree
    from autodist_tpu_torch.observability import goodput
    t_phase = time.perf_counter()
    print(f"phase 23: the multi-process runtime; BERT-base MLM {batch_size} "
          f"x {seq}, {cfg.num_layers} layers, two gloo ranks on the card "
          f"lose one at step {crash}, the chief re-execs at world size 1",
          flush=True)
    os.makedirs(directory, exist_ok=True)
    ckpt = os.path.join(directory, "ckpt")
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    knobs = {"device": device, "config": fields,
             "dtype": str(cfg.dtype).split(".")[-1], "batch": batch_size,
             "seq": seq, "masked": masked, "total": total, "unroll": unroll}
    run_id = f"phase23-{os.getpid()}-{time.time_ns()}"
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("AUTODIST_", "RANK", "WORLD_SIZE",
                                 "MASTER_", "LOCAL_RANK"))}
    base.update(PYTHONPATH=ROOT, AUTODIST_TELEMETRY="1",
                CUBLAS_WORKSPACE_CONFIG=":4096:8")
    me = os.path.abspath(__file__)

    # (b) the control arm, one process that resumes the same checkpoints,
    # starts with (a): it sets up while generation 0 trains, and reads the
    # checkpoints once the chief's last word before its re-exec is on disk
    # (the re-exec joins every checkpoint write first).
    after = os.path.join(directory, "elastic-g0-r0.json")
    if os.path.exists(after):
        os.remove(after)
    spec1 = _elastic_spec(os.path.join(directory, "control.yml"), ["proc0"])
    control = _elastic_start(
        "control", [sys.executable, me, "--elastic-train", spec1, ckpt,
                    directory, json.dumps(dict(knobs, arm="control",
                                               after=after))],
        dict(base, AUTODIST_WORKING_DIR=os.path.join(directory,
                                                     "wd-control")),
        directory)
    try:
        # (a) the elastic arm: a free port, one retry where it was taken
        # first.
        for attempt in range(2):
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            spec = _elastic_spec(os.path.join(directory, "elastic.yml"),
                                 ["proc0", "proc1"], port)
            wd = os.path.join(directory, f"wd-elastic{attempt}")
            env = dict(base, AUTODIST_SUPERVISION="elastic",
                       AUTODIST_CHAOS=f"kill_at={crash}:1",
                       AUTODIST_RUN_ID=run_id, AUTODIST_WORKING_DIR=wd)
            try:
                elastic_s, out = _elastic_finish(_elastic_start(
                    "elastic", [sys.executable, me, "--elastic-train", spec,
                                ckpt, directory, json.dumps(knobs)], env,
                    directory), spare=[control])
                break
            except RuntimeError as e:
                if attempt or "ddress already in use" not in str(e):
                    raise
                shutil.rmtree(ckpt, ignore_errors=True)
        g0 = [json.load(open(os.path.join(directory,
                                          f"elastic-g0-r{r}.json")))
              for r in range(2)]
        g1 = json.load(open(os.path.join(directory, "elastic-g1.json")))
        check([g["why"] for g in g0] == ["re-exec", "chaos:kill"] and
              all(g["world"] == 2 and g["backend"] == "gloo" for g in g0),
              f"(a) generation 0: {g0}")
        check(g1["world"] == 1 and g1["start"] == crash - 1 and
              g1["step"] == total and g1["backend"] == ("nccl" if device ==
                                                        "cuda" else "gloo"),
              f"(a) generation 1 resumed at {g1['start']} to {g1['step']} on "
              f"{g1['world']} {g1['backend']} rank(s)")
        for g in g0:
            check(g["completed_steps"] == crash,
                  f"(a) rank {g['rank']} completed {g['completed_steps']} "
                  f"steps")
        layers = cfg.num_layers
        if device == "cuda":
            for g in g0:
                for name, n in g["launches"].items():
                    check(n == layers * crash,
                          f"(a) rank {g['rank']} launched {name} {n} times "
                          f"in {crash} steps, not {layers} a step")
            for name, n in g1["launches"].items():
                check(n == layers * (total - crash + 1),
                      f"(a) generation 1 launched {name} {n} times, not "
                      f"{layers} x {total - crash + 1}")
            check(g1["captured"] and g1["replays"] == 1,
                  f"(a) generation 1's graph: captured {g1['captured']}, "
                  f"replays {g1['replays']}")
        kinds = {k for k, _ in _elastic_events(os.path.join(wd, "logs"))}
        missing = [k for k in ELASTIC_KINDS if k not in kinds]
        check(not missing, f"(a) the event trail lacks {missing}: "
              f"{sorted(kinds)}")
        skipped = [d for k, d in _elastic_events(os.path.join(wd, "logs"))
                   if k == "emergency-save"]
        traces = sorted(os.listdir(os.path.join(wd, "traces")))
        check(any(t.endswith("_g0.json") for t in traces),
              f"(a) generation 0's trace was not flushed before the exec: "
              f"{traces}")

        control_s, _ = _elastic_finish(control)
    finally:
        if control.poll() is None:
            stop_descendants(control.pid)
            control.kill()
            control.wait()
    ctl = json.load(open(os.path.join(directory, "control-g0.json")))
    check(ctl["start"] == crash - 1 and ctl["step"] == total,
          f"(b) the control arm resumed at {ctl['start']} to {ctl['step']}")
    got = flatten_params(read_tree(os.path.join(directory,
                                                "elastic-g1-params")))
    want = flatten_params(read_tree(os.path.join(directory,
                                                 "control-g0-params")))
    differ = _same(torch, got, want)
    worst = max((float((got[n].float() - want[n].float()).abs().max())
                 for n in want if n in got), default=0.0)
    check(not differ, f"(b) {len(differ)} params of the elastic arm differ "
          f"from the control arm's (max abs {worst:.3e}): {differ[:5]}")
    check(g1["loss"] == ctl["loss"],
          f"(b) losses {g1['loss']} vs {ctl['loss']}")

    # (c) the stitched ledger.
    log_dir = os.path.join(wd, "logs")
    st = goodput.stitch_run(run_id, log_dir)
    check(st is not None and st["generations"] == [0, 1],
          f"(c) stitched generations {st and st['generations']}")
    classes = st["classes"]
    steps_each = [s["steps"] for s in st["segments"]]
    check(steps_each == [crash, total - crash + 1] and
          st["steps"] == total + 1,
          f"(c) stitched steps {steps_each} = {st['steps']}")
    check(st["reexec_gaps_ms"][0] > 0 and classes["reexec_gap_ms"] > 0 and
          classes["reshard_ms"] > 0, f"(c) gap {st['reexec_gaps_ms']}, "
          f"reshard {classes['reshard_ms']}")
    whole = st["goodput_ms"] + sum(classes.values())
    check(abs(whole - st["wall_ms"]) <= max(1.0, ELASTIC_RECONCILE *
                                            st["wall_ms"]),
          f"(c) goodput + classes {whole:.3f} ms vs wall {st['wall_ms']} ms")
    check(st["mfu"] is not None and 0 < st["mfu"] <= 1,
          f"(c) stitched MFU {st['mfu']}")
    with open(g1["page"]) as f:
        page = f.read()
    check("stitched across generations" in page and
          'title="re-exec gap' in page,
          "(c) the chief's report page lacks the stitched goodput and its "
          "re-exec gap bar")
    # The planted fault: a directory without generation 1 is no stitch.
    lone = os.path.join(directory, "lone-logs")
    os.makedirs(lone, exist_ok=True)
    for path in glob.glob(os.path.join(log_dir, f"goodput_*_g0.json")):
        shutil.copy(path, lone)
    fault = goodput.stitch_run(run_id, lone)
    check(fault["generations"] == [0] and not fault["reexec_gaps_ms"],
          f"(c) the planted fault (no generation 1) reads as stitched: "
          f"{fault['generations']}")
    saved_dir = goodput.const.DEFAULT_LOG_DIR
    try:
        goodput.const.DEFAULT_LOG_DIR = lone
        os.environ["AUTODIST_RUN_ID"] = run_id
        goodput.set_last_summary(fault["segments"][0])
        check("stitched across generations" not in report._render_goodput(),
              "(c) the planted fault's report reads as stitched")
    finally:
        goodput.const.DEFAULT_LOG_DIR = saved_dir
        os.environ.pop("AUTODIST_RUN_ID", None)
        goodput.set_last_summary(None)

    seg0, seg1 = st["segments"]
    print(f"  (a) generation 0: two gloo ranks, {crash} steps each, wall "
          f"{seg0['wall_ms'] / 1e3:.3f} s (segment), rank 0 "
          f"{g0[0]['seconds']:.3f} s / rank 1 {g0[1]['seconds']:.3f} s of "
          f"process; the worker killed at step {crash}; re-exec gap "
          f"{st['reexec_gaps_ms'][0]:.3f} ms; generation 1: one NCCL rank, "
          f"steps {g1['start']} -> {g1['step']} (unroll {unroll}: graph "
          f"captured, {g1['replays']} replay), wall "
          f"{seg1['wall_ms'] / 1e3:.3f} s (segment), restore "
          f"{g1['restore_ms']:.3f} ms of which reshard "
          f"{g1['reshard_ms']} ms; job {elastic_s:.3f} s; events "
          f"{sorted(k for k in kinds if k in ELASTIC_KINDS)}; "
          f"emergency-save: {skipped}", flush=True)
    for g in g0:
        print(f"  (a) generation 0 rank {g['rank']} flash launches in its "
              f"{g['completed_steps']} completed steps {g['launches']} "
              f"(dispatched {g['dispatched']})", flush=True)
    print(f"  (a) generation 1 flash launches {g1['launches']} in "
          f"{total - crash + 1} steps; loss {g1['loss']}", flush=True)
    print(f"  (b) control arm ({control_s:.3f} s from its start with (a)): "
          f"params bitwise equal "
          f"({len(want)} tensors), losses {ctl['loss']}", flush=True)
    print(f"  (c) stitched: wall {st['wall_ms']:.3f} ms, goodput "
          f"{st['goodput_ms']:.3f} ms ({st['goodput_pct']}%), steps "
          f"{steps_each}, MFU {st['mfu']:.6f}; classes "
          f"{json.dumps({k: v for k, v in classes.items() if v})}; on "
          f"{card}", flush=True)
    took = time.perf_counter() - t_phase
    print(f"  phase 23 took {took:.1f} s", flush=True)
    check(took <= ELASTIC_PHASE_S or device != "cuda",
          f"phase 23 took {took:.1f} s, over {ELASTIC_PHASE_S} s")
    return {"elastic_g0": {k: g0[0]["launches"][k] + g0[1]["launches"][k]
                           for k in g1["launches"]},
            "elastic_g1": g1["launches"],
            "elastic_control": ctl["launches"]}


# Phase 24: the other gradient-sync kinds (the wire compressors with their
# error-feedback state, the hierarchical two-leg all-reduce, the overlap
# scheduler and its measured exposed comms).

GS_WORLD, GS_STEPS, GS_LR = 4, 2, 0.1
GS_KNOBS = ("AUTODIST_OVERLAP", "AUTODIST_AR_BUCKET_MB", "AUTODIST_HIER_ICI",
            "AUTODIST_ZERO1_AG_SCOPE", "AUTODIST_TELEMETRY", "AUTODIST_TRACE")
# (key, builder expression, knobs, its one-rank reference). A run is held
# to the one-rank run of its reference on the whole batch (the same rows):
# the plain mean for the uncompressed wire and the overlap scheduler, the
# same wire on one rank for a compressor (PowerSGD's factors are linear in
# the gradient, so the ranks' mean factor is the mean gradient's; the bf16
# and int8 wires round each rank's gradient where one rank rounds the
# mean).
GS_RUNS = (
    ("horovod", "AllReduce(compressor='HorovodCompressor')", {}, "horovod"),
    ("horovod_ef", "AllReduce(compressor='HorovodCompressorEF')", {},
     "horovod_ef"),
    ("int8", "AllReduce(compressor='Int8Compressor')", {}, "int8"),
    ("int8_ef", "AllReduce(compressor='Int8CompressorEF')", {}, "int8_ef"),
    ("powersgd", "AllReduce(compressor='PowerSGDCompressor')", {},
     "powersgd"),
    ("dcn_int8_ef", "AllReduce(all_reduce_spec='DCN', "
     "compressor='Int8CompressorEF')", {"AUTODIST_HIER_ICI": "2"}, "int8_ef"),
    ("overlap_off", "AllReduce()", {"AUTODIST_AR_BUCKET_MB": "16"}, "f32"),
    ("overlap_on", "AllReduce()", {"AUTODIST_OVERLAP": "1",
                                   "AUTODIST_AR_BUCKET_MB": "16"}, "f32"),
)
GS_REFS = {"f32": "AllReduce()",
           "horovod": "AllReduce(compressor='HorovodCompressor')",
           "horovod_ef": "AllReduce(compressor='HorovodCompressorEF')",
           "int8": "AllReduce(compressor='Int8Compressor')",
           "int8_ef": "AllReduce(compressor='Int8CompressorEF')",
           "powersgd": "AllReduce(compressor='PowerSGDCompressor')"}
# Loss (max relative) and whole-update (relative L2) tolerances: the plain
# wire's are phase 8's; a lossy wire's take its rounding of each rank's
# gradient. Each must lie above the floor (the f32 reference again) and
# the update's below the planted fault (the reference at twice the lr).
GS_TOLS = {"f32": (1e-3, 5e-2), "lossy": (1e-2, 2.5e-1)}
# (a)'s tolerances: the int8 wire's q and scales bitwise (one IEEE
# division, one rounding), the EF residual at 1e-6 of its magnitude; the
# orthogonalization and approximation at 1e-5 (reductions in another
# order on the card).
GS_WIRE_RTOL = 1e-5
GS_PHASE_S = 90.0


def _gs_builder(expr):
    from autodist_tpu_torch import strategy as S
    return eval(expr, vars(S))  # noqa: S307 - our table


def _gs_env(knobs):
    for k in GS_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(knobs)


def gs_wire_phase(torch, device):
    """(a): the wire functions on ``device``'s tensors against their plain
    CPU results at BERT-base's shapes: the int8 quantization of a word
    embedding gradient (q and scales equal), its error-feedback residual,
    and PowerSGD's orthogonalization and rank-2 approximation of a 768 x
    3072 gradient. Returns {check: max abs error}."""
    from autodist_tpu_torch.kernel.synchronization import compressor as comp
    gen = torch.Generator().manual_seed(24)
    grad = torch.randn(30522 * 768, generator=gen) * 1e-3
    grad[:4096] = 0.0  # all-zero blocks: scale 0
    state = torch.randn(grad.shape, generator=gen) * 1e-5
    out = {}

    def ef(g, s):
        corrected = g + s
        q, scale, pad = comp._int8_quantize(corrected)
        deq = (q.float() * scale).reshape(-1)
        return q, scale, corrected - (deq[:-pad] if pad else deq)
    q0, s0, r0 = ef(grad, state)
    q1, s1, r1 = ef(grad.to(device), state.to(device))
    check(torch.equal(q1.cpu(), q0) and torch.equal(s1.cpu(), s0),
          f"(a) the int8 wire's q / scales differ on the card: "
          f"{int((q1.cpu() != q0).sum())} q, {int((s1.cpu() != s0).sum())} "
          f"scales of {s0.numel()}")
    out["int8_q"] = int((q1.cpu().int() - q0.int()).abs().max())
    out["ef_residual"] = float((r1.cpu() - r0).abs().max())
    check(out["ef_residual"] <= 1e-6 * float(r0.abs().max()),
          f"(a) the EF residual differs by {out['ef_residual']}")
    m = torch.randn(768, 3072, generator=gen)
    q = torch.randn(3072, 2, generator=gen)
    ps = comp.PowerSGDCompressor
    p_hat = ps._orthogonalize(m @ q)
    approx = p_hat @ (m.t() @ p_hat).t()
    p_hat_d = ps._orthogonalize(m.to(device) @ q.to(device))
    approx_d = p_hat_d @ (m.to(device).t() @ p_hat_d).t()
    out["orthogonalize"] = float((p_hat_d.cpu() - p_hat).abs().max())
    out["approximation"] = float((approx_d.cpu() - approx).abs().max() /
                                 approx.abs().max())
    check(out["orthogonalize"] <= GS_WIRE_RTOL and
          out["approximation"] <= GS_WIRE_RTOL,
          f"(a) PowerSGD's factors differ on the card: {out}")
    return out


def gs_train_rank(rank, world, port, spec):
    """One rank of phase 24 (b) / (c): a gloo world over ``localhost`` on
    the card; every run of ``GS_RUNS`` (``GS_STEPS`` eager SGD steps of
    BERT on this rank's rows, from the seeded init), then one profiled
    ``Runner.run`` with telemetry on. Prints {run: losses, launches, the
    update's error against its reference, a digest of the params, the
    wire tally per step and its prediction} and the profiled run's
    measured exposed comms, estimate and sources."""
    import datetime
    import tempfile
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import observability
    from autodist_tpu_torch.kernel.synchronization import hierarchical
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.observability import attribution
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    spec = json.loads(spec)
    device = spec["device"]
    os.environ["AUTODIST_WORKING_DIR"] = os.path.join(spec["dir"],
                                                      f"wd{rank}")
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    fields = dict(spec["config"], dtype=getattr(torch, spec["dtype"]))
    cfg = T.TransformerConfig(**fields)
    batch = bert.synthetic_batch(cfg, spec["batch"], spec["seq"],
                                 spec["masked"], seed=0)
    refs = torch.load(spec["refs"], map_location=device)
    local = spec["batch"] // world
    mine = tuple(a[rank * local:(rank + 1) * local] for a in batch)
    out = {"rank": rank}
    for key, expr, knobs, ref in GS_RUNS:
        _gs_env(dict(knobs, AUTODIST_TELEMETRY="0"))
        observability.refresh()
        # Bitwise overlap on / off: the embedding gradient's scatter
        # without atomics.
        torch.use_deterministic_algorithms(key.startswith("overlap"),
                                           warn_only=True)
        hierarchical.reset_wire_tally()
        run = strategy_run(torch, fa, cfg, device, f"rank {rank} {key}",
                           _gs_builder(expr), mine, spec["steps"],
                           backend="gloo", optimizer="SGD", lr=GS_LR)
        tally = hierarchical.wire_tally()
        runner = run.runner
        sizes = {v.name: v.size_bytes for v in runner.program.graph_item
                 .variables}
        predicted = hierarchical.program_wire_split(
            runner.program.synchronizers, sizes,
            runner.program.data_axis_size)
        out[key] = {
            "losses": run.losses, "launches": run.launches,
            "mesh": dict(runner.program.mesh.shape),
            "update_error": update_error(torch, run.params,
                                         refs[ref]["params"], run.init),
            "loss_rel": _rel(run.losses, refs[ref]["losses"]),
            "digest": _digest(torch, [t for _, t in
                                      sorted(run.params.items())]),
            "sync_state": sorted(run.state.sync_state),
            "overlap": runner._overlap,
            "buckets": len(runner.bucket_plan()),
            "legs": [getattr(s, "_legs", lambda: None)() for s in
                     list(runner.program.synchronizers.values())[:1]],
            "tally": {k: v / spec["steps"] for k, v in tally.items()},
            "predicted": predicted}
        del run, runner
    torch.use_deterministic_algorithms(False)
    # (c) one profiled run a rank, the scheduler on: the measured exposed
    # comms beside the cost model's estimate.
    _gs_env({"AUTODIST_OVERLAP": "1", "AUTODIST_AR_BUCKET_MB": "16"})
    observability.refresh()
    observability.reset()
    autodist_mod._reset_default()
    from autodist_tpu_torch import AutoDist
    params = bert.init(cfg, torch.Generator().manual_seed(0), device=device)
    ad = AutoDist(strategy_builder=_gs_builder("AllReduce()"), device=device)
    runner = ad.create_distributed_session(ad.capture(
        bert.make_loss_fn(cfg), params,
        functools.partial(torch.optim.SGD, lr=GS_LR), example_batch=mine))
    state = runner.create_state()
    trace_dir = tempfile.mkdtemp(dir=spec["dir"])
    state, _ = runner.run(state, iter([mine] * spec["steps"]),
                          spec["steps"], trace_dir=trace_dir)
    gauges = observability.registry().snapshot().get("gauges") or {}
    summ = attribution.last_summary() or {}
    windows, steps = runner._windows or ([], 1)
    from autodist_tpu_torch.kernel.overlap import overlap_share
    out["profiled"] = {
        "exposed_ms": gauges.get("comms.exposed_ms_per_step"),
        "hidden_share": round(overlap_share(windows), 4),
        "estimate_ms": summ.get("raw_comms_ms"),
        "attr_exposed_ms": summ.get("exposed_comms_ms"),
        "sources": summ.get("sources"), "windows": len(windows),
        "steps": steps, "wire_ici": gauges.get("comms.wire_ici_bytes")}
    del state, runner, params
    _gs_env({})
    autodist_mod._reset_default()
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def gradsync_phase(torch, fa, card, cfg, device, batch_size=32 * GS_WORLD,
                   seq=128, num_masked=20, steps=GS_STEPS):
    """Phase 24: (a) :func:`gs_wire_phase`; (b) ``GS_WORLD`` gloo ranks of
    this script (``--gs-train``) on the one card train ``cfg`` at full
    width (``batch_size / GS_WORLD`` rows a rank) under each of
    ``GS_RUNS``: every compressor, the hierarchical int8 + EF wire split 2
    hosts x 2 (``AUTODIST_HIER_ICI=2``) and ``AllReduce()`` with the
    overlap scheduler on and off (16 MiB buckets), each held to its
    one-rank reference between the floor and the planted fault, the ranks'
    params equal, the flash kernels launched once a layer and step, the
    wire tally per leg equal to ``hier_wire_split``'s prediction and the
    overlap on / off params bitwise equal; (c) each rank's measured
    exposed comms of one profiled run beside the cost model's estimate,
    with the attribution's sources. Returns {path: flash launches, summed
    over the ranks}."""
    import tempfile
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.ops import build
    t_phase = time.perf_counter()
    wire = gs_wire_phase(torch, device)
    print(f"phase 24 (a): the wire functions on {device} tensors against "
          f"their CPU results: int8 q / scales of a 30522 x 768 gradient "
          f"bitwise (max |dq| {wire['int8_q']}), EF residual max abs "
          f"{wire['ef_residual']:.3e}, PowerSGD orthogonalization "
          f"{wire['orthogonalize']:.3e} and rank-2 approximation "
          f"{wire['approximation']:.3e} relative (tol {GS_WIRE_RTOL})",
          flush=True)
    print(f"phase 24 (b), {GS_WORLD} gloo ranks on one device: a "
          f"{cfg.num_layers}-layer, width {cfg.dim} BERT (batch "
          f"{batch_size} x {seq}, {batch_size // GS_WORLD} rows a rank, SGD "
          f"{GS_LR}, {steps} eager steps) under " +
          ", ".join(k for k, _, _, _ in GS_RUNS), flush=True)
    batch = bert.synthetic_batch(cfg, batch_size, seq, num_masked, seed=0)
    refs = {}
    try:
        for ref, expr in GS_REFS.items():
            run = strategy_run(torch, fa, cfg, device, f"one rank {ref}",
                               _gs_builder(expr), batch, steps,
                               optimizer="SGD", lr=GS_LR)
            refs[ref] = {"losses": run.losses,
                         "params": {n: t.detach().cpu()
                                    for n, t in run.params.items()}}
            init = run.init
            del run
        again = strategy_run(torch, fa, cfg, device, "one rank f32 again",
                             _gs_builder(GS_REFS["f32"]), batch, steps,
                             optimizer="SGD", lr=GS_LR)
        fault = strategy_run(torch, fa, cfg, device,
                             "one rank f32 at twice the lr",
                             _gs_builder(GS_REFS["f32"]), batch, steps,
                             optimizer="SGD", lr=2 * GS_LR)
    finally:
        autodist_mod._reset_default()
    cpu = {n: t.cpu() for n, t in init.items()}
    want = refs["f32"]
    floor = (_rel(again.losses, want["losses"]),
             update_error(torch, {n: t.cpu() for n, t in again.params.items()},
                          want["params"], cpu))
    faulty = (_rel(fault.losses, want["losses"]),
              update_error(torch, {n: t.cpu() for n, t in fault.params.items()},
                           want["params"], cpu))
    del again, fault, init
    print(f"  one-rank references (SGD {GS_LR}, the whole batch): " +
          "; ".join(f"{k} {', '.join(f'{x:.6f}' for x in r['losses'])}"
                    for k, r in refs.items()) +
          f"; floor (f32 again): loss {floor[0]:.3e}, update {floor[1]:.3e};"
          f" planted fault (lr x 2): loss {faulty[0]:.3e}, update "
          f"{faulty[1]:.3e}; tolerances {GS_TOLS} (on {card})", flush=True)
    for name, (lt, ut) in GS_TOLS.items():
        check(floor[0] <= lt and floor[1] < ut < faulty[1],
              f"phase 24 {name} tolerances {lt}, {ut} do not lie between "
              f"the floor {floor} and the fault {faulty}")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    refs_path = os.path.join(tmp.name, "refs.pt")
    torch.save(refs, refs_path)
    fields = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    spec = json.dumps({"device": device, "config": fields,
                       "dtype": str(cfg.dtype).split(".")[-1], "seq": seq,
                       "batch": batch_size, "masked": num_masked,
                       "steps": steps, "refs": refs_path, "dir": tmp.name})
    t0 = time.perf_counter()
    try:
        ranks = _spawn_ranks(GS_WORLD, "--gs-train", spec,
                             "a gradient-sync rank", timeout=600)
    finally:
        tmp.cleanup()
    world_s = time.perf_counter() - t0
    paths = {}
    for key, expr, knobs, ref in GS_RUNS:
        got = [r[key] for r in ranks]
        g = got[0]
        tol = GS_TOLS["f32" if ref == "f32" else "lossy"]
        rel = max(x["loss_rel"] for x in got)
        err = max(x["update_error"] for x in got)
        tally, pred = g["tally"], g["predicted"]
        measured = (f"ici {tally['ici']:.1f} / dcn {tally['dcn']:.1f} "
                    f"measured (the hierarchical reduces' tally), "
                    if key.startswith("dcn") else "")
        print(f"  {key}: {expr}{' ' + json.dumps(knobs) if knobs else ''} "
              f"(mesh {g['mesh']}, legs {g['legs'][0]}, {g['buckets']} "
              f"bucket(s), sync state on {len(g['sync_state'])} variables): "
              f"losses {', '.join(f'{x:.6f}' for x in g['losses'])}; vs the "
              f"one-rank {ref}: loss {rel:.3e} (tol {tol[0]}), update "
              f"{err:.3e} (tol {tol[1]}); wire bytes a rank and step per "
              f"leg: {measured}ici {pred['ici']:.1f} / dcn "
              f"{pred['dcn']:.1f} predicted; params "
              f"equal on every rank: {len({x['digest'] for x in got}) == 1}"
              f"; flash launches per rank and step "
              f"{json.dumps({k: v / steps for k, v in g['launches'].items()})}",
              flush=True)
        check(all(x["losses"] == g["losses"] for x in got),
              f"phase 24 {key}: the ranks' losses differ")
        check(len({x["digest"] for x in got}) == 1,
              f"phase 24 {key}: the ranks' params differ")
        check(rel <= tol[0] and err <= tol[1], f"phase 24 {key}: loss "
              f"{rel:.3e} / update {err:.3e} off its reference (tol {tol})")
        check(all(x["mesh"] == {"data": GS_WORLD} for x in got),
              f"phase 24 {key}: mesh {g['mesh']}")
        stateful = "_ef" in key or key == "powersgd"
        check(bool(g["sync_state"]) == stateful,
              f"phase 24 {key}: sync state on {g['sync_state']}")
        if key.startswith("dcn"):
            check(g["legs"][0] == [2, 2], f"phase 24 {key}: legs "
                  f"{g['legs'][0]}")
            check(tally["dcn"] > 0 and all(
                abs(tally[k] - pred[k]) <= 1e-9 * pred[k]
                for k in ("ici", "dcn")), f"phase 24 {key}: the wire tally "
                f"{tally} is not the prediction {pred}")
        check(g["overlap"] == (key == "overlap_on"),
              f"phase 24 {key}: the scheduler is {g['overlap']}")
        paths[f"gradsync_gloo{GS_WORLD}_{key}"] = {
            k: sum(x["launches"][k] for x in got) for k in g["launches"]}
    on = [r["overlap_on"]["digest"] for r in ranks]
    off = [r["overlap_off"]["digest"] for r in ranks]
    print(f"  overlap on vs off: params bitwise equal on every rank: "
          f"{on == off}", flush=True)
    check(on == off, "phase 24 (b): overlap on and off give other params")
    for r in ranks:
        p = r["profiled"]
        print(f"phase 24 (c) rank {r['rank']}: measured exposed comms "
              f"{p['exposed_ms']} ms/step ({p['windows']} collective "
              f"windows over {p['steps']} steps, hidden share "
              f"{p['hidden_share']}), the attribution's {p['attr_exposed_ms']}"
              f" ms; the cost model's estimate {p['estimate_ms']} ms; sources "
              f"{json.dumps(p['sources'], sort_keys=True)}", flush=True)
        check(p["exposed_ms"] is not None and p["exposed_ms"] > 0 and
              p["windows"] > 0, f"phase 24 (c) rank {r['rank']}: no "
              f"measured exposed comms {p}")
        check((p["sources"] or {}).get("exposed_comms") == "torch-profiler",
              f"phase 24 (c) rank {r['rank']}: sources {p['sources']}")
    took = time.perf_counter() - t_phase
    print(f"  phase 24 took {took:.1f} s (the {GS_WORLD}-rank world "
          f"{world_s:.1f} s), on {card}", flush=True)
    if device == "cuda":
        check(took <= GS_PHASE_S, f"phase 24 took {took:.1f} s (limit "
              f"{GS_PHASE_S} s)")
    return paths


# ``--capture-loop N [--blocking M]``: phase 20 alone, N times, each in a
# process and a working directory of its own (the first M with
# CUDA_LAUNCH_BLOCKING=1), counting
# the runs that fail and the Python GC passes that start while the calling
# thread's stream captures a CUDA graph (a finalizer run there may call
# CUDA inside the capture), with (b)'s two timings of the graph step and
# the card's clocks, power and throttle reasons sampled while each ran.
def capture_once_main(torch):
    import gc
    import tempfile
    import traceback
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_all()
    counts = {"gc_in_capture": {}, "gc_total": 0}

    def watch(phase, info):
        if phase != "start":
            return
        counts["gc_total"] += 1
        if torch.cuda.is_current_stream_capturing():
            gen = str(info.get("generation"))
            counts["gc_in_capture"][gen] = \
                counts["gc_in_capture"].get(gen, 0) + 1
    gc.callbacks.append(watch)
    global _graph_step_ms
    timed, inner = [], _graph_step_ms

    def sampled(torch, runner, state, block, **kw):
        """(b)'s timing, with the card's clocks, power and throttle
        reasons sampled every 0.2 s while it runs."""
        clocks, stop = [], threading.Event()

        def poll():
            while not stop.is_set():
                clocks.append(subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                     "power.draw,clocks_throttle_reasons.active",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True).stdout.strip())
                stop.wait(0.2)
        thread = threading.Thread(target=poll)
        thread.start()
        try:
            state, ms = inner(torch, runner, state, block, **kw)
        finally:
            stop.set()
            thread.join()
        timed.append({"ms": ms, "clocks": sorted(set(clocks))})
        return state, ms
    _graph_step_ms = sampled
    error = None
    directory = tempfile.mkdtemp(dir=build.BUILD_DIR)
    try:
        observe_phase(torch, fa, card_line(), bert.bert_base(max_len=128),
                      "cuda", directory)
    except Exception as e:  # noqa: BLE001 - the probe counts failures
        error = "".join(traceback.format_exception(e))[-3000:]
    finally:
        _graph_step_ms = inner
        gc.callbacks.remove(watch)
        shutil.rmtree(directory, ignore_errors=True)
    print(json.dumps(dict(counts, ok=error is None, error=error,
                          timings=timed,
                          seconds=time.perf_counter() - t0)), flush=True)
    return 0


def capture_loop_main(argv):
    n = int(argv[argv.index("--capture-loop") + 1])
    blocking = int(argv[argv.index("--blocking") + 1]) \
        if "--blocking" in argv else 0
    import tempfile
    from autodist_tpu_torch.ops import build
    print(card_line(), flush=True)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    runs = []
    for i in range(n):
        # Each run's own working directory: phase 20 checks the calibration
        # files it feeds, as in a full run's one pass.
        work = tempfile.mkdtemp(dir=build.BUILD_DIR)
        env = dict(os.environ, AUTODIST_WORKING_DIR=work)
        if i < blocking:
            env["CUDA_LAUNCH_BLOCKING"] = "1"
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--capture-once"],
                env=env, capture_output=True, text=True, timeout=900)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        try:
            result = json.loads(proc.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            result = {"ok": False, "error": proc.stderr[-3000:]}
        result.update(run=i, blocking=i < blocking, code=proc.returncode)
        runs.append(result)
        print(json.dumps(result), flush=True)
    failed = [r["run"] for r in runs if not r["ok"]]
    print(f"capture loop: {n} runs of phase 20 ({blocking} with "
          f"CUDA_LAUNCH_BLOCKING=1), {len(failed)} failed {failed}; GC "
          f"passes begun during a capture: "
          f"{[r.get('gc_in_capture') for r in runs]}", flush=True)
    return 0


# Phase 16 (``--cards 4``): the ported lowerings on four cards over NCCL.
#
# One process per card, started with torchrun's environment (RANK,
# WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), so the first
# AutoDist's Cluster.start opens the NCCL world on cuda:LOCAL_RANK; each
# later session joins it (``_reset_default(keep_world=True)``), and every
# session that lays out a mesh again takes the world's cached groups.
CARDS = 4
# Steps a run takes eagerly and again through its graph step (BERT under
# data parallelism takes 4: run(unroll=4) is one block); the graph step is
# then timed over CARD_TIMED replays and profiled over CARD_PROFILED.
CARD_STEPS, CARD_DP_STEPS, CARD_TIMED, CARD_PROFILED = 3, 4, 10, 2
CARD_LR = 0.1
# (key, part, model, builder expression, mesh, reference). A run is held to
# the reference model's one-rank steps on card 0 (the same seeded init and
# global batch, SGD CARD_LR) and its graph step to its own eager steps.
CARD_RUNS = (
    ("sp_ring", "b", "lm_sp", 'SequenceParallel("ring", 4)',
     {"data": 1, "seq": 4}, "lm_sp"),
    ("sp_ulysses", "b", "lm_sp", 'SequenceParallel("ulysses", 4)',
     {"data": 1, "seq": 4}, "lm_sp"),
    ("tp_ar", "b", "bert_tp", "ModelParallel(AllReduce(), model_axis=2)",
     {"data": 2, "model": 2}, "bert_tp"),
    ("tp_ps", "b", "bert_tp", "ModelParallel(PS(), model_axis=2)",
     {"data": 2, "model": 2}, "bert_tp"),
    ("ep_ar", "b", "ep", "ModelParallel(AllReduce(), model_axis=2, "
     "rules=moe.EXPERT_RULES, mesh_axis='expert')",
     {"data": 2, "expert": 2}, "ep"),
    ("ep_ps", "b", "ep", "ModelParallel(PS(), model_axis=2, "
     "rules=moe.EXPERT_RULES, mesh_axis='expert')",
     {"data": 2, "expert": 2}, "ep_shard"),
    ("pp", "b", "lm_pp", "Pipeline(num_stages=4, num_microbatches=8)",
     {"data": 1, "pipe": 4}, "lm_pp"),
    ("tp_sp", "c", "bert_cp",
     'ModelParallel(SequenceParallel("ring", 2), model_axis=2)',
     {"data": 1, "seq": 2, "model": 2}, "bert_cp"),
    ("pp_sp", "c", "lm_pp",
     'SequenceParallel("ring", 2, base=Pipeline(num_stages=2, '
     'num_microbatches=4))', {"data": 1, "pipe": 2, "seq": 2}, "lm_pp"),
    ("pp_tp", "d", "lm_pptp", "pp_tp_builder(S)",
     {"data": 1, "pipe": 2, "model": 2}, "lm_pptp"),
    ("ep_tp", "d", "ep_tp", "ep_tp_builder(S, moe)",
     {"data": 1, "expert": 2, "model": 2}, "ep_tp"),
    ("dp_ar", "a", "bert_dp", "AllReduce()", {"data": 4}, "bert_dp"),
    ("dp_zero1", "a", "bert_dp", "PS()", {"data": 4}, "bert_dp"),
    ("dp_fsdp", "a", "bert_dp", "PartitionedPS()", {"data": 4}, "bert_dp"),
    ("dp_parallax", "a", "bert_dp", "Parallax()", {"data": 4}, "bert_dp"),
    ("dp_stale2", "a", "bert_dp", "PS(staleness=2)", {"data": 4},
     "bert_dp_stale"),
    ("dp_resnet", "a", "resnet", "AllReduce(chunk_size=128)", {"data": 4},
     None),
    # (e) the other gradient-sync kinds over NCCL (phase 24's on four
    # cards), each with its knobs (CARD_KNOBS).
    ("e_int8_ef", "e", "bert_dp", "AllReduce(compressor='Int8CompressorEF')",
     {"data": 4}, "bert_dp_int8_ef"),
    ("e_powersgd", "e", "bert_dp",
     "AllReduce(compressor='PowerSGDCompressor')", {"data": 4},
     "bert_dp_powersgd"),
    ("e_dcn", "e", "bert_dp", "AllReduce(all_reduce_spec='DCN', "
     "compressor='Int8CompressorEF')", {"data": 4}, "bert_dp_int8_ef"),
    ("e_ar_off", "e", "bert_dp", "AllReduce()", {"data": 4}, "bert_dp"),
    ("e_ar_on", "e", "bert_dp", "AllReduce()", {"data": 4}, "bert_dp"),
    ("e_ps_use", "e", "bert_dp", "PS()", {"data": 4}, "bert_dp"),
)
# The environment knobs of a run (set before its session, cleared after).
CARD_KNOBS = {
    "e_dcn": {"AUTODIST_HIER_ICI": "2"},
    "e_ar_off": {"AUTODIST_AR_BUCKET_MB": "16"},
    "e_ar_on": {"AUTODIST_OVERLAP": "1", "AUTODIST_AR_BUCKET_MB": "16"},
    "e_ps_use": {"AUTODIST_OVERLAP": "1", "AUTODIST_ZERO1_AG_SCOPE": "use"}}
# A compressed run's reference: the same wire on one card (phase 24's
# reasoning), with the lossy wires' tolerances.
CARD_REF_BUILDERS = {
    "bert_dp_int8_ef": "AllReduce(compressor='Int8CompressorEF')",
    "bert_dp_powersgd": "AllReduce(compressor='PowerSGDCompressor')"}
# Loss (max relative) and whole-update (relative L2) tolerances by model:
# phases 8, 10, 12 and 13's. Each must lie above the model's floor (its
# one-rank run again) and the update's below the planted fault (the
# one-rank run at twice the learning rate: a doubled gradient).
CARD_TOLS = {"bert_dp": (1e-3, 5e-2), "bert_tp": (1e-3, 5e-2),
             "bert_cp": (1e-3, 5e-2), "lm_sp": (2e-4, 5e-2),
             "lm_pp": (1e-4, 5e-2), "ep": (2e-5, 2e-3),
             "lm_pptp": (PPTP_LOSS_RTOL, PPTP_UPDATE_RTOL),
             "ep_tp": (EPTP_LOSS_RTOL, EPTP_UPDATE_RTOL),
             "bert_dp_lossy": GS_TOLS["lossy"]}
CARD_PARTS = ("a", "b", "c", "d", "e")


def _card_tol(name, ref):
    """A run's (loss, update) tolerances: its reference's lossy wire's, or
    its model's."""
    if ref in CARD_REF_BUILDERS:
        return CARD_TOLS["bert_dp_lossy"]
    return CARD_TOLS.get(name.replace("_shard", ""))


def _card_launches(key, layers):
    """The flash and hop launches a rank and step of run ``key`` over a
    model of ``layers`` layers (phases 10-15's counts: a layer's attention
    a step; a ring hop one flash kernel each way)."""
    if key.startswith("dp_resnet") or key.startswith("ep_"):
        return _hop_launches(0, 1, 1, ring=False)
    if key.startswith(("dp_", "tp_ar", "tp_ps", "e_")):
        return _hop_launches(layers, 1, 1, ring=False)
    if key == "sp_ring":
        return _hop_launches(layers, 1, 4)
    if key == "sp_ulysses":
        return _hop_launches(layers, 1, 4, ring=False)
    if key == "pp":
        return _hop_launches(layers // 4 * 8, 1, 1, ring=False)
    if key == "pp_tp":
        return _hop_launches(layers // 2 * 4, 1, 1, ring=False)
    if key == "tp_sp":
        return _hop_launches(layers, 1, 2)
    return _hop_launches(layers // 2 * 4, 1, 2)  # pp_sp


def card_model(torch, name, device, tiny=False):
    """A four-card model from seed 0: (loss_fn, params, global batch,
    layers). ``tiny`` shrinks every width for a CPU rehearsal."""
    from autodist_tpu_torch.models import bert, resnet
    from autodist_tpu_torch.models import lm
    from autodist_tpu_torch.models import transformer as T
    if name.startswith("bert"):
        max_len = 128 if name == "bert_dp" else 512
        cfg = bert.bert_tiny(max_len=64, dtype=torch.bfloat16) if tiny \
            else bert.bert_base(max_len=max_len)
        rows = 128 if name == "bert_dp" else 32
        seq = 32 if tiny else 128
        batch = bert.synthetic_batch(cfg, 8 if tiny else rows, seq,
                                     5 if tiny else 20, seed=0)
        return (bert.make_loss_fn(cfg), bert.init(
            cfg, torch.Generator().manual_seed(0), device=device), batch,
            cfg.num_layers)
    if name.startswith("lm"):
        sp = name == "lm_sp"
        if tiny:
            cfg = T.TransformerConfig(vocab=256, dim=64, num_heads=4,
                                      num_layers=2 if sp else 4,
                                      max_len=64, causal=True,
                                      dtype=torch.bfloat16)
            batch = 2 if sp else 8
        else:
            cfg = lm.lm1b()
            cfg.num_layers = 2 if sp else 16
            cfg.max_len = 16384 if sp else 1024
            batch = 2 if sp else 8
        cfg.scan_layers = not sp
        params, _ = _lm_init(torch, cfg, device)
        return (lm.make_loss_fn(cfg), params,
                (sp_tokens(cfg, batch, cfg.max_len),), cfg.num_layers)
    if name.startswith("ep"):
        widths = dict(d_model=64, d_hidden=128) if tiny else {}
        cfg = ep_config(torch, **widths)
        batch = ep_batch(torch, cfg, 8 if tiny else EP_BATCH,
                         16 if tiny else EP_SEQ, "cpu")
        loss = ep_loss(cfg)
        if name == "ep_shard":  # PS: each data shard a batch of its own
            half = batch[0].shape[0] // 2
            whole = loss

            def loss(params, b):
                return (whole(params, tuple(a[:half] for a in b)) +
                        whole(params, tuple(a[half:] for a in b))) / 2
        return loss, ep_init(torch, cfg, device), batch, 0
    cfg = resnet.cifar_resnet(depth=8, num_classes=10) if tiny \
        else resnet.resnet50()
    images = 16 if tiny else 224
    batch = resnet.synthetic_batch(8 * CARDS if tiny else 64 * CARDS,
                                   images, cfg.num_classes, seed=0)
    return (resnet.make_loss_fn(cfg), resnet.init(
        cfg, torch.Generator().manual_seed(0), device=device), batch, 0)


def _card_rows(batch, index, n):
    """Data replica ``index`` of ``n``'s rows of every leaf."""
    per = len(batch[0]) // n
    return tuple(a[index * per:(index + 1) * per] for a in batch)


def _card_session(torch, builder, model, device, batch, lr=CARD_LR):
    """A runner of ``model`` under ``builder`` (the world kept for the
    next session), from the seeded init; and the init by name."""
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    autodist_mod._reset_default(keep_world=True)
    loss_fn, params, _, _ = model
    init = {n: t.detach().clone() for n, t in flatten_params(params).items()}
    ad = AutoDist(strategy_builder=builder, device=device)
    runner = ad.create_distributed_session(ad.capture(
        loss_fn, params, functools.partial(torch.optim.SGD, lr=lr),
        example_batch=batch))
    return runner, init


def _card_steps(torch, fa, device, call, state, batch, steps):
    """``steps`` calls: (state, losses, host ms per call, launches)."""
    _ring_counts(fa, reset=True)
    losses, times = [], []
    for _ in range(steps):
        (state, m), ms = _timed(torch, device, lambda: call(state, batch))
        losses += [float(x) for x in m["loss"].reshape(-1)]
        times.append(ms)
    return state, losses, times, _ring_counts(fa)


def _nccl_rows(rows):
    """(NCCL kernels' device us, the other kernels' us, {NCCL kernel:
    us}) of a profile's rows (us, count, name)."""
    nccl = {}
    for us, _, name in rows:
        if "nccl" in name.lower():
            short = name.split("(")[0]
            nccl[short] = nccl.get(short, 0.0) + us
    compute = sum(us for us, _, name in rows if "nccl" not in name.lower())
    return sum(nccl.values()), compute, nccl


def card_run(torch, fa, spec, run, model, ref):
    """One run of ``CARD_RUNS`` on this rank: eager steps, then the graph
    step (``make_callable(aot=True)``; the AllReduce run also
    ``run(unroll=4)``) from the same init; returns what the parent checks
    and prints."""
    import torch.distributed as dist
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.parallel import moe
    key, _, name, expr, axes, _ = run
    device = spec["device"]
    rank = int(os.environ["RANK"])
    builder = eval(expr, dict(  # noqa: S307 - our table
        vars(S), moe=moe, S=S, pp_tp_builder=pp_tp_builder,
        ep_tp_builder=ep_tp_builder))
    steps = CARD_DP_STEPS if name == "bert_dp" and key != "dp_stale2" \
        else CARD_STEPS
    batch = model[2]
    data = axes.get("data", 1)
    runner, init = _card_session(torch, builder, model, device,
                                 _card_rows(batch, 0, data))
    mesh = runner.program.mesh
    mine = runner.remapper.shard_batch(
        _card_rows(batch, mesh.axis_index("data"), data))
    out = {"mesh": dict(mesh.shape), "strategy": runner.program.strategy.id,
           "kinds": sorted({k for k, _ in runner.var_kinds.values()}),
           "layers": model[3]}
    paths = ["eager", "graph"] + (["unroll4"] if key in ("dp_ar", "e_ps_use")
                                  else [])
    if key == "dp_resnet":
        paths = ["graph"]
    finals = {}
    for path in paths:
        state = runner.create_state()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if path == "unroll4":
            blocks = lambda s, b: runner.run(s, iter([b] * steps), steps,
                                             unroll=steps)
            state, losses, times, launches = _card_steps(
                torch, fa, device, blocks, state, mine, 1)
        else:
            call = runner.make_callable(mine, aot=path == "graph")
            state, losses, times, launches = _card_steps(
                torch, fa, device, call, state, mine, steps)
        # Copies: the timed calls below go on updating the state in place.
        final = {n: t.clone() for n, t in flatten_params(
            runner.logical_params(state)).items()}
        got = {"losses": losses, "ms": times,
               "launches": {k: v / steps for k, v in launches.items()},
               "peak_bytes": torch.cuda.max_memory_allocated()
               if device == "cuda" else 0}
        if ref is not None:
            want = {n: t.to(device) for n, t in ref["params"].items()}
            got["update_error"] = update_error(torch, final, want, init)
            got["loss_rel"] = _rel(losses, ref["losses"])
            del want
        stored = flatten_params(state.params)
        kinds = runner.var_kinds
        got["whole"] = _digest(torch, (t for n, t in sorted(stored.items())
                                       if kinds[n][0] not in ("tp", "fsdp")))
        if path == "eager":
            out["stored_bytes"] = sum(t.numel() * t.element_size()
                                      for t in stored.values())
            out["whole_bytes"] = sum(t.numel() * t.element_size()
                                     for t in final.values())
        if path == "graph":
            timed_ms = []
            for _ in range(CARD_TIMED):
                (state, _), ms = _timed(torch, device,
                                        lambda: call(state, mine))
                timed_ms.append(ms)
            got["timed_ms"] = timed_ms
            if device == "cuda":
                got["captures"] = len(call.graphs)
                got["replays"] = sum(g.replays for g in call.graphs.values())
            held = [state]

            def one():  # every rank steps its state: the same phases
                held[0], _ = call(held[0], mine)
            if device == "cuda" and rank == 0:
                wall, _, rows = _profile_step(torch, one, n=CARD_PROFILED)
                nccl, compute, kernels = _nccl_rows(rows)
                got["profile"] = {
                    "wall_ms": wall / 1e3 / CARD_PROFILED,
                    "nccl_ms": nccl / 1e3 / CARD_PROFILED,
                    "compute_ms": compute / 1e3 / CARD_PROFILED,
                    "nccl_kernels": {k: v / 1e3 / CARD_PROFILED
                                     for k, v in kernels.items()}}
            else:
                for _ in range(CARD_PROFILED):
                    one()
            state = held[0]
            if device == "cuda":
                torch.cuda.synchronize()
            if key == "dp_fsdp":
                from autodist_tpu_torch.checkpoint import CheckpointManager
                mgr = CheckpointManager(runner, spec["ckpt4"])
                mgr.save(int(state.step), state, force=True)
                mgr.wait_until_finished()
                mgr.close()
                out["saved_step"] = int(state.step)
                out["saved_logical"] = {n: _digest(torch, [t]) for n, t in
                                        flatten_params(runner.logical_params(
                                            state)).items()}
                # The one-card checkpoint restored into this world.
                restored = CheckpointManager(
                    runner, spec["ckpt1"]).restore_or_init()
                back = flatten_params(runner.logical_params(restored))
                out["restored_from_one"] = {n: _digest(torch, [t])
                                            for n, t in back.items()}
                del restored, back
        finals[path] = final
        out[path] = got
        del state
    if "eager" in finals:
        for path in paths[1:]:
            out[path]["vs_eager_update"] = update_error(
                torch, finals[path], finals["eager"], init)
            out[path]["vs_eager_loss"] = _rel(out[path]["losses"],
                                              out["eager"]["losses"])
    if run[1] == "e":
        # This rank's measured exposed comms: a profiled run(unroll=4) of
        # two blocks (the graph's NCCL kernels against the compute beside
        # them), after an unprofiled block that captures the graph (the
        # ranks' captures finish apart, and a collective waits for the
        # last).
        import tempfile
        from autodist_tpu_torch.kernel import overlap as overlap_mod
        state = runner.create_state()
        state, _ = runner.run(state, iter([mine] * CARD_DP_STEPS),
                              CARD_DP_STEPS, unroll=CARD_DP_STEPS)
        with tempfile.TemporaryDirectory(
                dir=os.path.dirname(spec["refs"])) as trace_dir:
            state, _ = runner.run(state, iter([mine] * 2 * CARD_DP_STEPS),
                                  2 * CARD_DP_STEPS, unroll=CARD_DP_STEPS,
                                  trace_dir=trace_dir)
        windows, profiled = runner._windows or ([], 1)
        out["exposed"] = {
            "ms": overlap_mod.exposed_collective_ms(windows, profiled),
            "hidden_share": overlap_mod.overlap_share(windows),
            "collective_ms": sum(w["dur_ms"] for w in windows) / profiled,
            "windows": len(windows), "steps": profiled,
            "sync_state": len(state.sync_state)}
        del state
    del finals, runner, init
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def cards_rank(spec_path):
    """One process of the four-card world (torchrun's environment): every
    selected run of ``CARD_RUNS`` in turn; writes its results to
    ``rank<r>.json`` beside the spec."""
    import torch
    import torch.distributed as dist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    with open(spec_path) as f:
        spec = json.load(f)
    device = spec["device"]
    if device == "cuda":
        # This rank's card before anything is placed (Cluster.start picks
        # the same one).
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.load_all()  # built by the parent: the same sources and flags
    refs = torch.load(spec["refs"], map_location="cpu", mmap=True)
    out = {"rank": int(os.environ["RANK"]), "runs": {}}
    models = {}
    for run in CARD_RUNS:
        if run[1] not in spec["parts"]:
            continue
        if run[2] not in models:
            models.clear()
            models[run[2]] = card_model(torch, run[2], device, spec["tiny"])
        t0 = time.perf_counter()
        print(f"run {run[0]}: {run[3]} on {run[4]}", flush=True)
        _gs_env(CARD_KNOBS.get(run[0], {}))
        out["runs"][run[0]] = card_run(torch, fa, spec, run, models[run[2]],
                                       refs.get(run[5]))
        _gs_env({})
        out["runs"][run[0]]["seconds"] = time.perf_counter() - t0
        print(f"run {run[0]}: {out['runs'][run[0]]['seconds']:.1f} s",
              flush=True)
        if device == "cuda":
            out["runs"][run[0]]["backend"] = dist.get_backend()
    models.clear()
    autodist_mod._reset_default(keep_world=True)
    dist.destroy_process_group()
    path = os.path.join(os.path.dirname(spec_path), f"rank{out['rank']}.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(json.dumps({"rank": out["rank"], "runs": len(out["runs"])}),
          flush=True)
    return 0


def _card_reference(torch, fa, device, model, steps, lr, rows=None,
                    builder="AllReduce()"):
    """One rank's ``builder`` steps of ``model`` on its global batch (or
    ``rows`` of it): (losses, final logical params on the host)."""
    batch = model[2] if rows is None else rows
    runner, _ = _card_session(torch, _gs_builder(builder), model, device,
                              batch, lr=lr)
    batch = runner.remapper.shard_batch(batch)
    call = runner.make_callable(batch)
    state, losses, _, _ = _card_steps(torch, fa, device, call,
                                      runner.create_state(), batch, steps)
    params = {n: t.detach().cpu() for n, t in
              flatten_params(runner.logical_params(state)).items()}
    del state, runner
    return losses, params


def cards_references(torch, fa, card, device, parts, tiny):
    """On card 0, for each model the selected runs hold: the reference,
    the floor (the reference again) and the planted fault (twice the
    learning rate); checks each model's tolerances between them. Returns
    {reference: {"losses", "params"}}."""
    from autodist_tpu_torch import autodist as autodist_mod
    refs = {}
    names = []
    for run in CARD_RUNS:
        if run[1] in parts and run[5] is not None and run[5] not in names:
            names.append(run[5])
    for ref in names:
        model_name = {"bert_dp_stale": "bert_dp", "ep_shard": "ep_shard",
                      "bert_dp_int8_ef": "bert_dp",
                      "bert_dp_powersgd": "bert_dp"}.get(ref, ref)
        builder = CARD_REF_BUILDERS.get(ref, "AllReduce()")
        model = card_model(torch, model_name, device, tiny)
        steps = CARD_DP_STEPS if model_name == "bert_dp" and \
            ref != "bert_dp_stale" else CARD_STEPS
        t0 = time.perf_counter()
        if ref == "bert_dp_stale":
            # PS(staleness=2) over CARD_STEPS steps: each data replica
            # takes its own steps on its rows, and the copies average at
            # the period's end: the mean of four one-rank runs.
            runs = [_card_reference(torch, fa, device, model, steps,
                                    CARD_LR, _card_rows(model[2], r, CARDS))
                    for r in range(CARDS)]
            refs[ref] = {
                "losses": [sum(r[0][i] for r in runs) / CARDS
                           for i in range(steps)],
                "params": {n: sum(r[1][n].float() for r in runs) / CARDS
                           for n in runs[0][1]}}
            print(f"  reference {ref}: the mean of {CARDS} one-rank runs on "
                  f"each replica's rows, losses "
                  f"{', '.join(f'{x:.6f}' for x in refs[ref]['losses'])} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            continue
        ref_losses, ref_params = _card_reference(torch, fa, device, model,
                                                 steps, CARD_LR,
                                                 builder=builder)
        again = _card_reference(torch, fa, device, model, steps, CARD_LR,
                                builder=builder)
        fault = _card_reference(torch, fa, device, model, steps,
                                2 * CARD_LR, builder=builder)
        init = {n: t.detach().cpu() for n, t in
                flatten_params(model[1]).items()}
        floor = (_rel(again[0], ref_losses),
                 update_error(torch, again[1], ref_params, init))
        faulty = (_rel(fault[0], ref_losses),
                  update_error(torch, fault[1], ref_params, init))
        tol = _card_tol(model_name, ref)
        print(f"  reference {ref}: one rank {builder}, losses "
              f"{', '.join(f'{x:.6f}' for x in ref_losses)}; floor (again): "
              f"loss {floor[0]:.3e}, update {floor[1]:.3e}; planted fault "
              f"(lr x 2): loss {faulty[0]:.3e}, update {faulty[1]:.3e}; "
              f"tolerances loss {tol[0]}, update {tol[1]} "
              f"({time.perf_counter() - t0:.1f} s, on {card})", flush=True)
        check(floor[0] <= tol[0], f"{ref}: the loss floor {floor[0]} is "
              f"above the tolerance {tol[0]}")
        check(floor[1] < tol[1] < faulty[1], f"{ref}: the update tolerance "
              f"{tol[1]} does not lie between the floor {floor[1]} and the "
              f"fault {faulty[1]}")
        refs[ref] = {"losses": ref_losses, "params": ref_params}
        del model, again, fault
    autodist_mod._reset_default()
    if device == "cuda":
        torch.cuda.empty_cache()
    return refs


def _card_one_rate(torch, fa, device, name, tiny, rows):
    """The one-card graph step of ``name`` at ``rows`` rows under
    AllReduce (the scaling cells' one-card side): median host ms over
    CARD_TIMED replays after CARD_STEPS calls."""
    from autodist_tpu_torch import strategy as S
    model = card_model(torch, name, device, tiny)
    batch = tuple(a[:rows] for a in model[2])
    builder = S.AllReduce(chunk_size=128) if name == "resnet" \
        else S.AllReduce()
    runner, _ = _card_session(torch, builder, model, device, batch)
    batch = runner.remapper.shard_batch(batch)
    call = runner.make_callable(batch, aot=True)
    state = runner.create_state()
    state, _, _, _ = _card_steps(torch, fa, device, call, state, batch,
                                 CARD_STEPS)
    times = []
    for _ in range(CARD_TIMED):
        (state, _), ms = _timed(torch, device, lambda: call(state, batch))
        times.append(ms)
    del state, runner, model
    return float(np.median(times))


def _spawn_card_world(spec_path, world, timeout):
    """``world`` processes of this script (``--cards-rank``) with
    torchrun's environment over a free ``localhost`` port; raises if one
    fails, and no process outlives the call."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RANK", "WORLD_SIZE", "MASTER_", "LOCAL_"))}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    logs = [os.path.join(os.path.dirname(spec_path), f"rank{r}.log")
            for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--cards-rank", spec_path],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=log, stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.time() > deadline:
                break
            time.sleep(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            with open(logs[r]) as f:
                tails.append(f"--- rank {r} (exit {procs[r].returncode}):\n"
                             + f.read()[-3000:])
        check(False, f"four-card ranks {failed} failed or ran out of "
              f"{timeout} s:\n" + "\n".join(tails))
    ranks = []
    for r in range(world):
        with open(os.path.join(os.path.dirname(spec_path),
                               f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def cards_phase(torch, fa, card, device, parts=CARD_PARTS, tiny=False,
                timeout=600):
    """Phase 16: the references on card 0, the four-card world, then every
    check between its floor and its planted fault, and the figures.
    Returns the ``kernels`` line's launches by path and its fields."""
    import tempfile
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch import strategy as S
    from autodist_tpu_torch.checkpoint import CheckpointManager
    from autodist_tpu_torch.ops import build
    t_phase = time.perf_counter()
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR)
    print(f"phase 16: {CARDS} cards, one process each over NCCL, parts "
          f"{', '.join(parts)}; references on card 0 (SGD {CARD_LR})",
          flush=True)
    refs = cards_references(torch, fa, card, device, parts, tiny)
    refs_path = os.path.join(tmp.name, "refs.pt")
    torch.save(refs, refs_path)
    one = {}
    ckpt1 = os.path.join(tmp.name, "ckpt1")
    if "a" in parts:
        # The one-card side of the scaling cells, and a one-card
        # checkpoint the world restores.
        one["bert_ms"] = _card_one_rate(torch, fa, device, "bert_dp", tiny,
                                        8 // 4 if tiny else 32)
        one["resnet_ms"] = _card_one_rate(torch, fa, device, "resnet", tiny,
                                          8 if tiny else 64)
        model = card_model(torch, "bert_dp", device, tiny)
        runner, _ = _card_session(torch, S.AllReduce(), model, device,
                                  model[2])
        call = runner.make_callable(model[2], shard_inputs=True)
        state, _, _, _ = _card_steps(torch, fa, device, call,
                                     runner.create_state(), model[2], 2)
        mgr = CheckpointManager(runner, ckpt1)
        mgr.save(2, state, force=True)
        mgr.wait_until_finished()
        mgr.close()
        one["ckpt1"] = {n: _digest(torch, [t]) for n, t in flatten_params(
            runner.logical_params(state)).items()}
        del state, runner, model, call
        print(f"  one card (the scaling cells' baseline): BERT-base graph "
              f"step at 32 x 128 {one['bert_ms']:.2f} ms, ResNet-50 at 64 x "
              f"224^2 {one['resnet_ms']:.2f} ms (median host ms over "
              f"{CARD_TIMED} replays, on {card})", flush=True)
    elif "e" in parts:
        one["bert_ms"] = _card_one_rate(torch, fa, device, "bert_dp", tiny,
                                        8 // 4 if tiny else 32)
        print(f"  one card (the scaling baseline): BERT-base graph step at "
              f"32 x 128 {one['bert_ms']:.2f} ms (median host ms over "
              f"{CARD_TIMED} replays, on {card})", flush=True)
    autodist_mod._reset_default()
    if device == "cuda":
        torch.cuda.empty_cache()
    spec_path = os.path.join(tmp.name, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"device": device, "tiny": tiny, "parts": list(parts),
                   "refs": refs_path, "ckpt1": ckpt1,
                   "ckpt4": os.path.join(tmp.name, "ckpt4")}, f)
    t0 = time.perf_counter()
    try:
        ranks = _spawn_card_world(spec_path, CARDS, timeout)
        print(f"  the {CARDS}-process world ran in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        paths = cards_report(torch, card, device, parts, tiny, ranks, one)
        if "a" in parts:
            # The four-card checkpoint restored on one card.
            model = card_model(torch, "bert_dp", device, tiny)
            runner, _ = _card_session(torch, S.AllReduce(), model, device,
                                      model[2])
            state = CheckpointManager(runner, os.path.join(
                tmp.name, "ckpt4")).restore_or_init()
            got = {n: _digest(torch, [t]) for n, t in flatten_params(
                runner.logical_params(state)).items()}
            want = ranks[0]["runs"]["dp_fsdp"]["saved_logical"]
            check(got == want, "(a) the four-card PartitionedPS() "
                  "checkpoint does not restore bitwise on one card")
            check(all(r["runs"]["dp_fsdp"]["restored_from_one"] ==
                      one["ckpt1"] for r in ranks), "(a) the one-card "
                  "checkpoint does not restore bitwise on four cards")
            print(f"  (a) checkpoints: PartitionedPS()'s four-card step "
                  f"{ranks[0]['runs']['dp_fsdp']['saved_step']} restored on "
                  f"one card, {len(got)} leaves "
                  f"bitwise; a one-card AllReduce() step 2 restored into "
                  f"the four-card PartitionedPS() world, every leaf bitwise "
                  f"on every rank", flush=True)
            del state, runner, model
    finally:
        autodist_mod._reset_default()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()  # the references'
        tmp.cleanup()
    print(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


def cards_report(torch, card, device, parts, tiny, ranks, one):
    """Prints every run of the four-card world, then checks them all;
    returns {path: launches per rank and step}."""
    paths = {}
    selected = [run for run in CARD_RUNS if run[1] in parts]
    for key, part, name, expr, axes, ref in selected:
        runs = [r["runs"][key] for r in ranks]
        r0 = runs[0]
        tol = _card_tol(name, ref)
        paths_here = [p for p in ("eager", "graph", "unroll4") if p in r0]
        g = r0.get("graph", {})
        prof = g.get("profile", {})
        line = (f"  ({part}) {key}: {expr} on {axes} (kinds "
                f"{'/'.join(r0['kinds'])})")
        for path in paths_here:
            got = r0[path]
            line += (f"; {path}: losses "
                     f"{', '.join(f'{x:.6f}' for x in got['losses'])}")
            if tol is not None:
                line += (f" (vs one rank: loss "
                         f"{max(r[path]['loss_rel'] for r in runs):.3e}, "
                         f"update "
                         f"{max(r[path]['update_error'] for r in runs):.3e})")
            if "vs_eager_update" in got:
                line += (f", vs eager: loss {got['vs_eager_loss']:.3e}, "
                         f"update {got['vs_eager_update']:.3e}")
        print(line, flush=True)
        eager_ms = r0["eager"]["ms"][1:] if "eager" in r0 else []
        graph_ms = g.get("timed_ms", [])
        stored = r0.get("stored_bytes")
        print(f"    step ms (host-inclusive, rank 0): eager "
              f"{float(np.median(eager_ms)) if eager_ms else float('nan'):.2f}"
              f", graph {float(np.median(graph_ms)) if graph_ms else float('nan'):.2f} "
              f"(median of {len(graph_ms)} replays; ranks: " + ", ".join(
                  f"{float(np.median(r['graph']['timed_ms'])):.2f}"
                  for r in runs if r.get("graph", {}).get("timed_ms")) +
              f"); launches per rank and step "
              f"{json.dumps(g.get('launches', {}))}; peak memory "
              f"{max(r['graph']['peak_bytes'] for r in runs if 'graph' in r) / 2**30:.2f}"
              f" GiB" + (f"; stores {stored} of {r0['whole_bytes']} "
                         f"parameter bytes" if stored else "") +
              f"; {r0['seconds']:.1f} s; on {card}", flush=True)
        if prof:
            busy = prof["compute_ms"] / prof["wall_ms"]
            print(f"    rank 0 profiled graph step ({CARD_PROFILED} "
                  f"replays): {prof['wall_ms']:.2f} ms wall, NCCL kernels "
                  f"{prof['nccl_ms']:.3f} ms device (" + ", ".join(
                      f"{k} {v:.3f}" for k, v in sorted(
                          prof["nccl_kernels"].items())) +
                  f"), other kernels {prof['compute_ms']:.2f} ms (busy share "
                  f"{busy:.3f})" + (
                      f"; the stage's busy share against the bubble: "
                      f"{busy:.3f} vs 1 - 3/11 = {8 / 11:.3f}"
                      if key == "pp" else ""), flush=True)
        if "exposed" in r0:
            print(f"    measured exposed comms a step (a profiled "
                  f"run(unroll={CARD_DP_STEPS}) of 2 blocks, after the "
                  f"capture's), by rank: " + ", ".join(
                      f"{r['exposed']['ms']:.3f} ms of "
                      f"{r['exposed']['collective_ms']:.3f} ms of collective "
                      f"kernels ({r['exposed']['hidden_share']:.3f} hidden)"
                      for r in runs) + f"; on {card}", flush=True)
        paths[f"cards{CARDS}_{key}"] = g.get("launches", {})
    if "e" in parts:
        r0 = ranks[0]["runs"]
        rows_bert = 2 if tiny else 32
        for key in ("e_ar_off", "e_ar_on"):
            ms4 = float(np.median(r0[key]["graph"]["timed_ms"]))
            print(f"  (e) scaling BERT-base, {key}: 1 card "
                  f"{rows_bert / one['bert_ms'] * 1e3:.1f} samples/s, "
                  f"{CARDS} cards {rows_bert / ms4 * 1e3:.1f} samples/s per "
                  f"card: efficiency {one['bert_ms'] / ms4:.3f} (part (a)'s "
                  f"AllReduce(): 0.865; on {card})", flush=True)
        same = [r["runs"]["e_ar_on"]["graph"]["whole"] ==
                r["runs"]["e_ar_off"]["graph"]["whole"] for r in ranks]
        print(f"  (e) overlap on vs off, the graph step's params bitwise "
              f"equal by rank: {same}", flush=True)
    if "a" in parts:
        r0 = ranks[0]["runs"]
        bert4 = float(np.median(r0["dp_ar"]["graph"]["timed_ms"]))
        resnet4 = float(np.median(r0["dp_resnet"]["graph"]["timed_ms"]))
        parallax = float(np.median(r0["dp_parallax"]["graph"]["timed_ms"]))
        rows_bert, rows_resnet = (2, 8) if tiny else (32, 64)
        print(f"  (a) Parallax() vs AllReduce() graph step on {CARDS} cards: "
              f"{parallax:.2f} vs {bert4:.2f} ms ({bert4 / parallax:.3f}x)",
              flush=True)
        for what, rows, ms1, ms4, unit in (
                ("BERT-base", rows_bert, one["bert_ms"], bert4, "samples"),
                ("ResNet-50", rows_resnet, one["resnet_ms"], resnet4,
                 "images")):
            print(f"  (a) scaling {what}: 1 card {rows / ms1 * 1e3:.1f} "
                  f"{unit}/s, {CARDS} cards {rows / ms4 * 1e3:.1f} {unit}/s "
                  f"per card ({CARDS * rows / ms4 * 1e3:.1f} in all): "
                  f"efficiency {ms1 / ms4:.3f} (on {card})", flush=True)
    # The checks, after every figure is printed.
    for key, part, name, expr, axes, ref in selected:
        runs = [r["runs"][key] for r in ranks]
        r0 = runs[0]
        tol = _card_tol(name, ref)
        paths_here = [p for p in ("eager", "graph", "unroll4") if p in r0]
        g = r0.get("graph", {})
        check(all(r["mesh"] == axes for r in runs), f"({part}) {key}: mesh "
              f"{r0['mesh']}, expected {axes}")
        check(len({r["strategy"] for r in runs}) == 1, f"({part}) {key}: the "
              f"ranks run different strategies (shipping)")
        if device == "cuda":
            check(all(r["backend"] == "nccl" for r in runs),
                  f"({part}) {key}: a {r0['backend']} world")
        for path in paths_here:
            got = [r[path] for r in runs]
            losses = got[0]["losses"]
            check(all(np.isfinite(losses)), f"({part}) {key} {path}: "
                  f"losses {losses}")
            check(all(g["losses"] == losses for g in got),
                  f"({part}) {key} {path}: the ranks' losses differ")
            check(len({g["whole"] for g in got}) == 1,
                  f"({part}) {key} {path}: the whole params differ across "
                  f"the ranks")
            if tol is not None:
                rel = max(g["loss_rel"] for g in got)
                err = max(g["update_error"] for g in got)
                check(rel <= tol[0], f"({part}) {key} {path}: losses "
                      f"{losses}, {rel:.3e} off one rank's (tol {tol[0]})")
                check(err <= tol[1], f"({part}) {key} {path}: update error "
                      f"{err:.3e} (tol {tol[1]})")
            if path != "eager" and "eager" in r0 and tol is not None:
                vs = (max(g["vs_eager_loss"] for g in got),
                      max(g["vs_eager_update"] for g in got))
                check(vs[0] <= tol[0] and vs[1] <= tol[1],
                      f"({part}) {key} {path} vs eager: loss {vs[0]:.3e}, "
                      f"update {vs[1]:.3e}")
            if device == "cuda":
                want = _card_launches(key, r0["layers"])
                check(all(g["launches"] == want for g in got),
                      f"({part}) {key} {path}: launches per rank and step "
                      f"{got[0]['launches']}, expected {want}")
        if "exposed" in r0:
            check(all(r["exposed"]["windows"] > 0 and
                      r["exposed"]["ms"] >= 0 for r in runs),
                  f"({part}) {key}: no measured collective windows")
        if device == "cuda" and "captures" in g:
            calls = len(g["losses"]) + CARD_TIMED  # counted before the profile
            check(g["replays"] == calls - g["captures"],
                  f"({part}) {key}: {g['replays']} replays of "
                  f"{g['captures']} graphs in {calls} calls")
    return paths


def cards_main(torch, argv):
    """``--cards 4 [--part a|b|c|d|e]``: phase 16 alone, on four cards."""
    parts = CARD_PARTS
    if "--part" in argv:
        parts = tuple(argv[argv.index("--part") + 1].split(","))
        check(set(parts) <= set(CARD_PARTS), f"--part {parts}: of "
              f"{', '.join(CARD_PARTS)}")
    n = int(argv[argv.index("--cards") + 1])
    check(n == CARDS, f"--cards {n}: this mode runs on {CARDS} cards")
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"chip_smoke --cards {CARDS}: needs {CARDS} CUDA cards, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa
    start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load_all()
    print(f"phase 1: built {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    paths = cards_phase(torch, fa, card, "cuda", parts)
    kernels = [{"name": k.__name__, "launches_by_path": {
        p: c.get(k.__name__, 0) for p, c in paths.items()}}
        for k in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                  fa.block_attn_fwd, fa.block_attn_bwd)]
    print(f"chip_smoke --cards {CARDS}: every check passed in "
          f"{time.perf_counter() - start:.1f}s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": CARDS}}), flush=True)
    return 0


def main():
    import torch
    if len(sys.argv) > 1 and sys.argv[1] == "--gloo-train":
        return gloo_train_rank(*(int(a) for a in sys.argv[2:5]),
                               sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--preempt-train":
        return preempt_train_child(sys.argv[2], sys.argv[3])
    if len(sys.argv) > 1 and sys.argv[1] == "--sp-train":
        return sp_train_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--tp-train":
        return tp_train_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--ep-train":
        return ep_train_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--pp-train":
        return pp_train_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--cp-train":
        return cp_train_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--ta-train":
        return ta_train_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--pp-auto":
        return pp_auto_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--obs-skew":
        return obs_skew_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--gs-train":
        return gs_train_rank(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    if len(sys.argv) > 1 and sys.argv[1] == "--capture-once":
        return capture_once_main(torch)
    if "--capture-loop" in sys.argv:
        return capture_loop_main(sys.argv)
    if len(sys.argv) > 1 and sys.argv[1] == "--elastic-train":
        return elastic_train_child(*sys.argv[2:6])
    if len(sys.argv) > 1 and sys.argv[1] == "--cards-rank":
        return cards_rank(sys.argv[2])
    if "--cards" in sys.argv:
        return cards_main(torch, sys.argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1
    from autodist_tpu_torch.ops import build
    from autodist_tpu_torch.ops import flash_attention as fa

    # No process this script starts outlives it: orphans come back here,
    # a SIGTERM (a time limit) takes every descendant along, and the run
    # fails if one is still there at the end.
    adopt_orphans()

    def ended(signum, frame):
        stop_descendants()
        os._exit(128 + signum)
    signal.signal(signal.SIGTERM, ended)

    start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    warm = child_bytecode_cache(build.BUILD_DIR)
    build.load_all()
    check(warm.wait() == 0, "the child processes' imports failed")
    print(f"phase 1: built {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f}s "
          f"(nvcc: {json.dumps(build.build_seconds)}; the children's "
          f"bytecode cached under {os.environ['PYTHONPYCACHEPREFIX']})",
          flush=True)
    for name, log in build.build_logs.items():
        for kernel, regs, spill in build.register_report(log):
            print(f"  {name}: {short_kernel(kernel)} {regs} registers, "
                  f"{spill} bytes spilled", flush=True)
            check(spill == 0 or _wgmma_instance(kernel) is None,
                  f"{short_kernel(kernel)} spills {spill} bytes")
        for line in log.splitlines():
            if "warning" in line.lower():
                print(f"  {name}: {line.strip()}", flush=True)
    sass_check(build)

    fwd = kernel_phase(torch, fa)
    bwd = backward_phase(torch, fa)
    routes = route_phase(torch, fa)
    from autodist_tpu_torch.models import bert
    served = serve_phase(torch, fa, card, bert.bert_base(max_len=512), "cuda")
    trained = train_phase(torch, fa, card, bert.bert_base(max_len=128),
                          "cuda")
    zoo = zoo_phase(torch, fa, card, "cuda")
    from autodist_tpu_torch.models import lm, resnet
    zoo["decode"] = decode_phase(torch, fa, card, lm.lm1b(), "cuda")
    zoo.update(graph_phase(torch, fa, card, bert.bert_base(max_len=128),
                           resnet.resnet50(), "cuda"))
    served_graph = graph_serve_phase(torch, fa, card,
                                     bert.bert_base(max_len=512), "cuda")
    zoo.update(strategy_phase(torch, fa, card, bert.bert_base(max_len=128),
                              "cuda"))
    zoo.update(gloo_strategy_phase(torch, fa, card,
                                   bert.bert_base(max_len=128), "cuda"))
    zoo.update(resilience_phase(torch, fa, card, bert.bert_base(max_len=512),
                                resnet.resnet50(), "cuda"))
    hops = ring_kernel_phase(torch, fa)
    zoo.update(sp_phase(torch, fa, card, "cuda"))
    tp_kernels = tp_kernel_phase(torch, fa)
    zoo.update(tp_phase(torch, fa, card, _gloo_bert(bert), "cuda"))
    import tempfile
    share = {"dir": tempfile.mkdtemp(dir=build.BUILD_DIR)}
    try:
        zoo.update(ep_phase(torch, fa, card, "cuda", share=share))
        zoo.update(pipeline_phase(torch, fa, card, "cuda", share=share))
        print("phase 14 (c) / 15 (c): the kernels at the composed paths' "
              "shapes", flush=True)
        composed = composed_hop_phase(torch, fa)
        ulysses_tp = tp_kernel_phase(
            torch, fa, shape=CP_ULYSSES_SHAPE, key="ulysses_tp",
            label="phase 14 (c)", who="Ulysses under TP: a rank's 3 heads "
            "over the whole sequence")
        zoo.update(composed_bert_phase(torch, fa, card, _gloo_bert(bert),
                                       "cuda"))
        zoo.update(composed_pipeline_phase(torch, fa, card, "cuda",
                                           share["reference"]))
        two_axis, pptp_kernels = two_axis_phase(
            torch, fa, card, "cuda", share["reference"],
            share["ep_reference"])
        zoo.update(two_axis)
        zoo.update(loader_phase(torch, fa, card, bert.bert_base(max_len=128),
                                resnet.resnet50(), "cuda"))
        zoo.update(cost_phase(torch, fa, card, "cuda", share["reference"],
                              bert.bert_base(max_len=128)))
        zoo.update(observe_phase(torch, fa, card, bert.bert_base(max_len=128),
                                 "cuda", share["dir"]))
        zoo.update(obs21_phase(torch, fa, card, "cuda",
                               bert.bert_base(max_len=512),
                               bert.bert_base(max_len=128), lm.lm1b(),
                               share=share))
        zoo.update(obs22_phase(torch, fa, card, "cuda",
                               bert.bert_base(max_len=128), share))
        zoo.update(elastic_phase(torch, fa, card, bert.bert_base(max_len=128),
                                 "cuda", os.path.join(share["dir"],
                                                      "elastic")))
        zoo.update(gradsync_phase(torch, fa, card, _gloo_bert(bert), "cuda"))
    finally:
        left = stop_descendants()
        shutil.rmtree(share["dir"], ignore_errors=True)
    check(not left, f"processes outlived their phases (killed): {left}")
    fwd["launches"] = served + trained["flash_fwd"]
    fwd["launches_by_path"] = {"serve": served,
                               "train": trained["flash_fwd"],
                               "graph_serve": served_graph}
    for record in bwd:
        record["launches"] = trained[record["name"]]
        record["launches_by_path"] = {"serve": 0,
                                      "train": trained[record["name"]],
                                      "graph_serve": 0}
    for record in [fwd] + bwd:
        record["launches_by_path"].update(
            {path: counts[record["name"]] for path, counts in zoo.items()})
        record["other_routes"] = routes[record["name"]]
        record.update(tp_kernels[record["name"]])
        record.update(ulysses_tp[record["name"]])
        record.update(pptp_kernels[record["name"]])
    for record in hops:  # their main path: the ring's steps in phase 10
        record["launches"] = zoo[f"sp_gloo{SP_WORLD}_ring"][record["name"]]
        record["launches_by_path"] = {
            path: counts.get(record["name"], 0)
            for path, counts in zoo.items()}
        record["composed"] = composed[record["name"]]
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - start:.1f}s; timings: {TIMINGS['profiles']}"
          f" profiles, {TIMINGS['empty']} with no device time, "
          f"{TIMINGS['events']} calls timed with CUDA events", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [fwd] + bwd + hops}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

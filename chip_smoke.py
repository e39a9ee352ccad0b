"""GPU smoke run of kubernetes_tpu_torch: the quickest proof that the port
builds, agrees with its plain versions and schedules on an NVIDIA GPU.

    python3 chip_smoke.py [--compare TAG=DIR] ...

Phases (each prints its wall time; any failed check exits non-zero):
  1. device facts (nvidia-smi name and power limit, CUDA, nvcc, ninja);
  2. build every CUDA source under kubernetes_tpu_torch/ops/csrc, with
     ptxas's registers and spills;
  3. the claims kernel against its plain torch version on the card
     (murmur: exact; sin: the tolerance rule of tests/test_torch_kernels.py)
     on random cases and on its edges (ragged P and N, identical nodes, dead
     pod tiles, R=2 and R=16), with its time per launch (median of
     CUDA-event timed launches);
  4. the slice on the GPU against the slice on the CPU, at murmur and at
     sin noise: 5,000 nodes, two batches of 4,096 pods, bit-identical
     result vectors and final state; then every claims launch of the GPU
     slice replayed on its own inputs, the kernel against itself and
     against the plain version on the GPU and on the CPU, and the sin
     noise of those launches compared between the GPU and the CPU;
  5. SchedulingBasic at bench shape: 5,000 nodes (32 CPU, 256Gi, 110
     pods), 49,152 pods (100m, 128Mi) in batches of 16,384 through
     TorchBatchBackend.assign;
  6. the north-star scale: 100,000 nodes, 12 batches of 16,384 (196,608
     pods: the Scheduling100k row's 200,000 cut to whole batches);
  7. the claims kernel held against its plain version again at the main
     path's two launch shapes, the wave's (P=16,384, sin) and the compacted
     tail's (P=512, murmur), each on the empty cluster of batch 1 (every
     node ties: the noise prune's worst case) and on the state the 100k run
     leaves, and at the wave shape with two alternating pod requests (the
     kernel's general path); timed beside three bounds (below) and, at the
     wave shape, the plain version.
  a. the full (constraint) variant on the GPU against the CPU: 5,000
     nodes in 3 zones, two batches of 1,024 pods mixing hard zone spread,
     hostname anti-affinity, node affinity and host ports; bit-identical
     result vectors and final state (cd_sg and cd_asg included);
  b. TopologySpreading at its published shape: 1,000 nodes in 3 zones,
     5,000 pods (100m, 128Mi, maxSkew 5 DoNotSchedule over zones), batch
     8,192 (two chunks of the full variant's cap);
  c. SchedulingPodAntiAffinity at its published shape: 5,000 nodes,
     5,000 hostname anti-affinity pods, batch 8,192;
  d. the north-star node count for the full variant: 100,000 nodes in 3
     zones, two batches of 8,192 TopologySpreading pods, chunked through
     the full_cap the card gives; then one more batch under the profiler.
     (b)-(d) check on the host, from the returned names, that every pod
     is placed, no status is ERROR, no node holds more than its CPU,
     memory or 110 pods, the zone counts stay within maxSkew and no two
     anti-affinity pods share a node, and print full_cap, waves per batch,
     the peak of allocated device memory and its bytes per (pod, node)
     cell.
  8. SchedulingBasic through the Scheduler: kubernetes_tpu_torch.perf.bench's
     config (5,000 nodes, 1,000 warm-up and 50,000 measured pods, batch
     16,384, depth 2): store, informers, queue, Scheduler with a
     TorchBatchBackend profile, bulk assume, binder;
  9. Scheduling100k through the Scheduler (100,000 nodes, 200,000 pods,
     batch 16,384, depth 2);
  e. the preemption dry-run kernel (csrc/preempt.cu) against its plain
     torch version on the card, all seven planes bit for bit, on seeded
     random cases (ragged N of 1,000 / 5,003 / 20,000, P of 1 / 37 / 256,
     V of 8 and 16, R of 5 / 6 / 8, PAD slots, PDB bits, overflow rows,
     taints, 1-3 nomination groups, inactive pods, priorities at the clamp
     bounds and above 2^24) and flatten-shaped ones (slots ascending with
     PAD at the tail, pods from a few templates: runs across the 64-pod
     block edge, keys changing pod to pod, V of 16 and 32); then at the
     100k chunk shape (P=256 x N=110,080) on random slots and on
     flatten-shaped ones (one key, 4 live slots a node): the wrapper's
     time, the bare launch's, the plain version's, the bound, and the
     kernel's registers, shared memory a block and resident blocks an SM;
     and K8 (torch) timed at that shape beside its bound;
  f. TorchBatchBackend.preempt_batch at 100,000 nodes of PreemptionBasic's
     shape (4 CPU, 32Gi) holding 4 priority-0 pods of 900m / 500Mi each
     (400,000 residents): one wave of 512 priority-10 preemptors (3000m,
     500Mi; 1,024 until the script's time limit called for less), 2
     dry-run chunks of 256; every result checked by arithmetic
     (victims on its node and of lower priority; with them evicted the
     preemptor fits beside the wave's earlier winners there); per chunk
     the dry run's time between CUDA events, the pull and the host
     selection; the peak device memory; the first chunk's planes held
     against the plain version and timed as in (e) (the kernels line's
     numbers; its launch_ms is the bare launch);
 10. SchedulingBasicPaced, the latency row (5,000 nodes, 24,000 pods
     arriving at 8,000 pods/s, batch 512, depth 12, 1 ms admission);
 11. PreemptionBasic through the Scheduler (its own 500 nodes, 2,000
     low-priority pods, 500 measured preemptors; batch 1,024, depth 1);
 12. PreemptionDense through the Scheduler (100 nodes, 800 residents,
     400 preemptors, four to a node);
 13-16. the constraint and gang rows at their workloads' scale:
     SchedulingPodAntiAffinity (5,000 nodes, 5,000 hostname anti-affinity
     pods), SchedulingHighCardinality (5,000 nodes, 20,000 pods in 2,000
     anti-affinity services), TopologySpreading (1,000 nodes, 5,000
     zone-spread pods) and CoschedulingGang (5,000 nodes, 10,000 pods in
     1,000 gangs of 10); batch 8,192, depth 2, 50 ms admission window;
 17. SchedulingHostNull: SchedulingBasic's 5,000 nodes and 50,000 pods
     with the device step nulled (ops/nullbackend.py, by name), depth 1,
     then the host ceiling at SchedulingBasic's depth 2: the nulled row
     and SchedulingBasic on the card in turns, one round each
     (HOST_CEILING_ROUNDS, cut from two for the script's time limit), the
     card's share of the ceiling per round and the spread of both;
 18. SchedulingOverloadFlood: 2,000 nodes, a 30,000-pod flood with every
     50th pod outside the tensor encoding, under the full overload policy
     and a seeded chaos schedule of slow and all-escape waves;
 19. SchedulingChurnStorm: 500 nodes, a 12,000-pod flood during a seeded
     storm of node adds, drains and relabels, default overload policy.
     8-19 run one pass a row (ROW_PASSES; bench.py runs its two_pass
     rows, 11-16, twice), print the bench row and for each pass its pods/s,
     pod e2e p50/p95/p99 ms, waves per batch, escape rate and its
     reasons and the set-up times outside the window, and check every
     pass from the store: every pod left is bound (the rest are deleted
     preemption victims), no node holds more than its CPU, memory or 110
     pods (the storm's drained nodes aside), no ERROR status, the escape
     rate is 0 (18-19, whose workloads mark pods the tensor path does not
     encode, must escape), the claims kernel launched in the pass where
     batches are plain and nothing launched on the nulled device; a
     failed pass fails the phase even when the row keeps the other one;
     after each pass of a row without preemption, one
     more batch of the row's own pods runs through the loop under
     torch.profiler (device busy time, idle share); 11-12 check that
     every high-priority pod is bound, a preemption attempt was counted
     and every dry-run chunk launched the preempt kernel; 18 that the
     chaos fired and no protected pod was shed; 19 that the storm added,
     drained and relabelled nodes and no pod was bound twice;
 20. checkpoint / warm start on the card: SchedulingBasic's first batch on
     one TorchBatchBackend, checkpoint_mirror, a fresh backend on the card
     warm-started from the file and a fresh cache primed with its objects,
     every row adopted, then the remaining batches on the fresh backend,
     placed pod for pod as the uninterrupted backend places them, every
     pod placed within capacity;
 21. observability: SchedulingBasic through the Scheduler (5,000 nodes,
     50,000 pods, batch 16,384, depth 2) with tracing at 1,000,000 per
     million, profiling.timeline and the device census armed, and with all
     three off, in turns, one round (OBS_ROUNDS, cut from two for the
     script's time limit; armed / off pods/s printed, no gate); the
     first armed pass prints the span count by name and checks that a
     bound batch's trace holds every pipeline span under its JAX
     parent, prints the timeline's stages, device idle share and per-pod
     segment quantiles, and runs one more batch under torch.profiler,
     whose busy time the timeline's device-stage union over the same
     window must cover (less 1%); every armed pass holds the census of
     both variants; then the census of both variants on a backend at
     Scheduling100k's caps (110,080 rows) after one batch on 100,000
     nodes, which must leave LAUNCHES, the state and _gen as they were,
     with each kernel's launches, device time, bytes and bound;
     then 10 steady batches at SchedulingBasic's shape under SyncGuard
     (every implicit sync at a `# sync-point:` site; the syncs per batch
     and per device wave) and BuildCounter (nothing built or loaded), and
     the same over 3 constraint batches of phase (a)'s mix on 5,000 nodes
     and one wave of 1,024 preemptors on 5,000 nodes of PreemptionBasic's
     shape.  The inspecting pass also holds every wave's device-step and
     d2h, read from CUDA events, inside the host's launch-to-resolve
     window for that wave (1 ms).  SyncGuard sees what torch's sync debug
     mode reports, which torch calls incomplete: its counts are lower
     bounds.
 22. the device worker in a separate process on the card (python3 -m
     kubernetes_tpu_torch.cmd.tpu_worker --port 0 --device cuda), and
     SchedulingBasic and Scheduling100k (the bench configs of 8-9)
     through the Scheduler with its batch backend behind the HTTP seam to
     that worker (RemoteTorchBatchBackend), held to 8-9's checks, pods/s
     printed beside 8-9's; then the worker's /debug/timeline, whose
     device-step intervals must be there; then the census over the
     seam: a RemoteTorchBatchBackend on that worker and a
     TorchBatchBackend in this process take the same two batches (4,096
     plain pods, 1,024 of (a)'s mix) on 5,000 zoned nodes, and
     device_census() through the worker (/census) must equal the
     in-process census in every field but device_ms;
 23. the RemoteSeamGrpc row (perf.bench.run_seam, bench.py's
     run_seam_micro: 5,000 nodes, six rounds of 4,096 plain pods through
     an in-process gRPC worker and through the in-process backend): pods/s
     both ways and their ratio, every round placed, the placements equal;
 24. the RemoteSeamFaulty row: seeded drops, delays and corrupt frames,
     one worker kill and resync, an outage that opens the failover
     breaker into the in-process rung and fails back; every round placed,
     the remote rung's rounds after the resync equal to the in-process
     run's, the breaker closed at the end, the faults printed.  23-24 run
     the HTTP seam, and say so, where grpc does not import;
 25. PreemptionBasic (one pass) through the Scheduler over the worker
     process of 22, held to 11's checks; the worker must have served
     /preempt;
 26. the multi-device sharded path (parallel/) at 100,000 nodes: the
     claims kernel at every shard's node_offset under 4 shards (P=16,384 x
     N=27,520, murmur) against its plain version, bit for bit, each launch
     timed; ShardedTorchBatchBackend.assign on make_mesh() (every visible
     card, one shard each) and on 4 shards of cuda:0, beside
     TorchBatchBackend at murmur noise, each on its own copy of phase 6's
     cluster, 2 batches of 16,384 plain pods (SHARD_BATCHES; 4 until the
     script's time limit called for less): the placements equal batch
     by batch, pods/s for each, the claims kernel launched once a shard
     per wave; the census's collective bytes a wave by kind on the 4-shard
     mesh (counts of a 4-device mesh: the shards share one card);
     SyncGuard's syncs a sharded wave over 2 more batches; one constraint
     batch of (a)'s mix at 5,000 nodes (zones round-robin, so every zone
     spans every shard) on 4 shards, equal to the single device's full
     variant pod for pod;
 27. Scheduling100k through the Scheduler with backend: sharded on
     make_mesh(), at bench.py's headline configuration (census and
     timeline armed), held to 9's checks, every batch plain and the
     claims kernel launched once a shard per wave, pods/s and p50/p99
     beside 9's; then TopologySpreading (15's row, one pass) on 4
     shards of cuda:0, held to 15's checks.  The two phases print their
     wall together;
 28. the single-device snapshot API (models/assign.py build_assign_fn):
     (i) Scheduling100k's cluster (100,000 nodes, 110,080 rows) and one
     batch of 4,096 of its pods through the strict scan (K10) on the
     card: every pod placed, no node over its CPU, memory or 110 pods,
     the first 256 pods' assignments equal to the CPU scan's, ms a pod
     (two runs), device activities a pod (torch.profiler, the difference
     of a 32- and a 96-pod run), SyncGuard's syncs
     inside the pod loop (must be 0) and in the call, and the bound; (ii)
     a 1,024-pod batch of (a)'s mix at 5,000 nodes: the scan and the wave
     on the card bit-identical to themselves on the CPU, the wave equal
     to build_sharded_assign_fn on make_mesh('cuda:0'), both solvers'
     placements within capacity, zone skew and anti-affinity;
 29. the entry points (kubernetes_tpu_torch/entry.py, the twin of
     __graft_entry__.py): entry() on the card equal to
     entry(device="cpu"); dryrun_multichip(4) on 4 shards of cuda:0 (n
     cards where that many are visible), its own checks passing, the
     claims kernel launched at least once a shard.  The two phases print
     their wall together, and the script its whole wall and, on a line of
     its own, K10's numbers (it has no hand kernel: not in the kernels
     line).
 30. the front door (apiserver/, client/http_client.py): SchedulingBasicHTTP
     (i) and SchedulingBasicHTTPProc (ii) at bench.py's parameters (5,000
     nodes, 10,000 measured pods, batch 4,096, depth 2) through
     perf.bench's run_once, the apiserver (RBAC, default admission, WAL)
     in process (i) and as python -m kubernetes_tpu_torch.cmd.apiserver
     (ii), every component speaking HTTP to it; then (iii) the same
     workload through LocalClient, with the timeline armed in all three;
     each row held to 8's checks, pods/s and pod e2e p50/p99 printed and
     the REST tax as (iii)'s pods/s over (i)'s and over (ii)'s; the
     in-process apiserver's GET /debug/timeline must hold the device
     stages, one claims wave recorded in (i) must replay equal to the
     plain version, (ii)'s apiserver process must be gone after its row
     and the phase must import no yaml module.
 31. in-process scale-out (scheduler/scaleout.py): (i)
     perf.bench.run_scaleout(4) at bench.py's --instances parameters
     (100,000 nodes of 64 CPU / 256Gi / 1,000 pods, 200,000 pods of 10m /
     16Mi, both created in chunks of 10,000, batch 16,384, depth 2, one
     shared MemoryStore) through 1, 2 and 4 Schedulers, each with its own
     TorchBatchBackend on the card: per count pods/s, wall, bound pods, the
     conflict taxonomy (lost_to_peer, requeued, fenced,
     already_bound_same_node), speedup_vs_1 and the pass's peak of
     allocated device memory; every pod bound, no node over its CPU,
     memory or pod cap, every instance's backend on the card with plain
     batches only; one profiled batch of 4,096 pods at N=1 and at N=2 (the
     device's idle share); (ii) two instances at full width with an
     InstanceChurner killing instance 0 after the second chunk of the
     flood and reviving it after the flood, each backend sized for the
     whole cluster (a survivor absorbs its peer's slices): every pod
     bound exactly once (bench.BindLedger over the store's pod history),
     the survivor's cache holding all 100,000 nodes after the kill, the
     fenced and requeued counts and every resync's time; (iii) one claims
     wave recorded from an instance in (i) at N=2 and one at N=4, each at
     that instance's n_cap, replayed through the kernel against the plain
     version, timed beside it and the bound.  Every pass also prints each
     instance's longest gap between two scheduling-loop ticks and between
     two lease renewals, the membership changes and the resyncs.
 32. the scheduler's binary (cmd/scheduler.py, client/leaderelection.py,
     scheduler/debugger.py): the apiserver as a process (RBAC, the
     default admission chain less the harness's list, a WAL) on 5,000
     nodes of SchedulingBasicHTTP's shape, and two binaries, each
     started as `chip_smoke.py --binary-child ARGS` (main unchanged, its
     claims launches counted from the end of the backend's warmup, its
     counts printed after every batch it retires and when main returns)
     with --tpu-batch --leader-elect
     --batch-size 4096 --node-capacity 5632 under system:kube-scheduler's
     token; the leader named by its "became leader" line and the Lease;
     1,000 warm-up pods bound; both caches in sync on SIGUSR2; a flood of
     20,000 pods, the leader SIGKILLed once 5,000 are bound, the follower
     leading and binding the rest; every pod bound exactly once within
     caps and no nodeName changed (a watch), the survivor in sync on
     SIGUSR2 and out with 0 within 10 s of SIGTERM; each binary's claims
     launches above 0 and its escapes 0 (the killed leader's as of the
     last batch it retired); pods/s before and after the kill, pod
     e2e p50/p99, the takeover gap and each binary's device memory.
 33. process-true scale-out (scheduler/procrun.py, ops/faults.py's
     ProcessChurner and upgrade pair, perf.bench --processes): (i)
     perf.bench.run_scaleout_proc at its row's shape (an apiserver
     process; 20,000 nodes of 64 CPU / 256Gi / 1,000 pods, 60,000 pods
     of 10m / 16Mi in chunks of 10,000, batch 4,096) through N = 1 and
     2 scheduler processes (PROC_MAX; the row's N = 4 runs on the null
     device only, in perf.bench --processes 4), each child a
     TorchBatchBackend on the card sized for the whole cluster, started
     as `chip_smoke.py --proc-child ARGS` with the timeline armed; at N >
     1 the seeded crash sub-pass (child 0 SIGKILLed, 3,000 more pods):
     per pass pods/s, the flood wall, speedup_vs_1, the federated
     conflict counts, each child's device memory (nvidia-smi memory.used
     before and with the children, over N) and the timeline's idle share
     per child as the supervisor federates it; every pod bound exactly
     once (the wire ledger) within caps; (ii) a rolling upgrade of two
     such children with a warm-start directory while 6,000 pods arrive
     in chunks: roll 0 clean, roll 1 sabotaged (one drain escalation),
     the clean child's respawn warm-starting with more than 0 rows, the
     escalated child's starting cold, every pod bound exactly once
     within caps; (iii) child 1 of the N=2 pass holds its first plain
     wave against the plain version in its own process, times both and
     the bound.  Every child that ran batches launched the claims kernel,
     with 0 escapes and plain batches only, as its own counts say (a
     killed child's as of its last retired batch).
 34. store replication (store/replica.py) under the scheduler: a
     primary store (a promoted FollowerStore) with a ReplicationHub in
     sync, fencing mode (sync_timeout 2 s, heartbeat 0.1 s) and a
     follower behind a TCP forwarder that can go silent both ways,
     auto-promoting after 5 s of silence; scheduler A (a TorchBatchBackend
     on the card, batch 4,096, depth 2) over the primary binds 1,000
     warm-up pods on 5,000 nodes of SchedulingBasicHTTP's shape, then a
     flood of 10,000; once 3,000 flood binds are acknowledged the
     forwarder freezes, A's next commit fences the primary and its bind
     wave requeues, A stops, the follower promotes itself and scheduler
     B (its own TorchBatchBackend on the card) over the promoted store
     relists and binds the rest; the deposed primary then rejoins as a
     follower of a hub on the promoted store.  Every bind A saw
     acknowledged stands on the promoted store on its node, every pod is
     bound exactly once within caps, the epoch rose by one, the deposed
     primary's pods equal the promoted store's after the rejoin, A and B
     each launched the claims kernel with plain batches and 0 escapes,
     and B's first recorded wave equals the plain version; pods/s before
     the partition beside 30(iii)'s, the times from the freeze to A's
     first FencedError, to the promotion and to B's first bind, A's
     acknowledged binds, the dirty tail and the card's memory printed.
 35. the node agent (kubelet/, cmd/kubelet.py): the apiserver as a
     process as in 32, the scheduler binary on the card (--binary-child,
     --tpu-batch --batch-size 4096) and one kubelet binary running
     KUBELET_NODES hollow nodes under an admin token; (i) the nodes and
     their Leases register, KUBELET_PODS pods are created in one bulk
     write, and every pod must be bound exactly once within caps and
     reach Running with Ready=True and its containerStatuses on its node
     (a watch), every node's Lease renewed at least once; (ii) a full
     kubelet binary (--full --node-name full-0 --root-dir) runs a pod
     with a readiness probe (Ready) and one whose container keeps exiting
     under restartPolicy Always (its pod reads Failed, ROADMAP R14(e),
     and its liveness probe has it restarted with a 0.25 s, then 0.5 s
     backoff), is SIGKILLed once its checkpoint holds both and restarted
     on the same root dir, and the running pod must then read Running,
     Ready=False and no containerStatuses (R14(d)), the Failed one keep
     its status; the scheduler's claims launches above 0 and its escapes
     0, SIGTERM ending every binary with 0 within 10 s; registration,
     bind and Running times, each binary's CPU and memory and the card's
     memory printed.
 36. the all-in-one cluster (controllers/, cmd/cluster.py): one process,
     `chip_smoke.py --cluster-child --secure-port 0 --nodes 500
     --tpu-batch --batch-size 4096` (cmd.cluster.main unchanged, its
     claims launches counted from the end of the backend's warmup, its
     first live wave kept), holding the apiserver, the scheduler on the
     card, the controller manager, the Endpoints controller and 500
     hollow nodes, driven over HTTPClient: the nodes and Leases register
     and the controllers the manager disabled are printed; a Service and
     a Deployment of 250 pods (100m, 128Mi) roll out (one ReplicaSet
     named by the recomputed pod-template-hash, every pod bound once
     within caps and Running and Ready on its node, the Endpoints and the
     EndpointSlices, named by the recomputed group id, on exactly their
     IPs); the template changes and a second ReplicaSet takes over while
     the first drains to 0 (ROADMAP R15: at most twice the pods alive);
     5 s of steady state give the store's writes per second by resource
     (R14(a)); a Background delete collects both ReplicaSets and every
     pod; SIGTERM ends the process with 0 within 10 s.  The step times,
     created-to-Ready p50/p99, the pods created for each ReplicaSet
     (R16), the process's CPU seconds, resident memory and threads are
     printed; the claims launches must be above 0 with 0 escapes, and
     the recorded wave must equal the plain version.
Phases 5 and 6 are the plain main path through TorchBatchBackend.assign,
8-10 the same path under the scheduler loop, (a)-(d) the full variant's,
f the preemption path at the seam and 11-12 under the loop, 13-19 the
other rows' paths under the loop: the kernels' launch counts are zeroed
just before each (before each pass in 8-19) and read just after (before
a pass's profiled batch; in 29 just before the dry run and just
after it); in 5, 6, 8-12, 16, 18, 19 and 29 the
claims kernel must have launched, in (a)-(d) no kernel (the full variant
reaches no hand kernel; 13-15 run it every batch), in 17 nothing, in f
and 11-12 the preempt kernel; in 26 the counts are zeroed just before
each sharded assign and read just after it (the single-device comparison
is not counted), in 27 before each pass;
every claims launch of 5 and 6 is recorded by shape (pods, live pods,
nodes, noise) with its time between CUDA events.  In 22 and 25 the
kernels launch in the worker process: its counts (GET /debug/kernels)
are zeroed before each pass and read after it, and the claims kernel
must have launched in 22, the preempt kernel in 25.  The last two lines
are a JSON line of per-kernel numbers (launches: claims in phases 6, 9,
22's Scheduling100k, 26's sharded assigns, 27's Scheduling100k and 29's
dry run, 30's three rows, 31's passes, 32's two binaries, 33's
children, 34's two schedulers, 35's scheduler binary and 36's
cluster; in 30 the
counts are zeroed just before each row and read in its `after` hook, in 31 when each pass starts and when its row (or the
churn's barrier) is read, in 32 in each binary's process when its warmup
ends, and read from the last count it printed: the survivor's as it
exits, the killed leader's after the last batch it retired; in 33
likewise in each child: a drained child's as it exits, a killed one's
after its last batch; in 34 for each scheduler from the end of its
backend's warmup to its stop, in 35 and 36 as in 32); preempt_dry_run in f,
11, 12 and 25) and the device line. Without a CUDA device the script exits 2 and prints no
result.

--compare TAG=DIR loads the kubernetes_tpu_torch package of another
checkout (e.g. an earlier revision, unpacked with git archive) under its
own name, and times its claims wrapper against this one's in phase 7 and
its dry_run_planes against this one's at phase e's 100k cases and phase
f's first chunk, in turns (this, other, other, this) on the same inputs,
after checking that both return the same answers.

--only seam runs phases 1-2 and 22-25, --only sharded phases 1-2 and
26-27 (27 then prints no single-device row beside its own), --only
snapshot phases 1-2, 28 and 29, --only http phases 1-2 and 30, --only
scaleout phases 1-2 and 31, --only binary phases 1-2 and 32, --only
proc phases 1-2 and 33, --only replica phases 1-2 and 34, --only
kubelet phases 1-2 and 35, --only cluster phases 1-2 and 36; --until 4
stops after phase 4
(--build-dir DIR builds the kernels there); --slice-runs N runs phases
1-4 in N fresh processes, each building the kernels cold into a
directory of its own, two at a time, with a process keeping the card busy
beside the second half (ROADMAP Q4).  None of them prints a result line.
--binary-child ARGS is phase 32's (and 35's) entry for one scheduler
binary, --proc-child ARGS phase 33's for one child of the process supervisor
(procrun's --child, its counts printed as --binary-child prints them),
--cluster-child ARGS phase 36's for the all-in-one cluster.
"""

import argparse
import gc
import importlib
import importlib.util
import inspect
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# the peak rates and the work counts of the kernels live beside them in the
# package (ops/kernels.py, models/preempt.py): the device census reads the
# same counts
from kubernetes_tpu_torch.models.preempt import dry_run_bound
from kubernetes_tpu_torch.ops.kernels import (
    H100_FP32_OPS_PER_S, H100_HBM_BYTES_PER_S, claims_bounds,
)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== phase {self.name}", flush=True)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        print(f"   phase {self.name} wall {time.monotonic() - self.t0:.3f} s",
              flush=True)
        return False


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"CHECK FAILED: {what}")


def time_cuda(fn, n: int, warmup: int = 2) -> float:
    """Median ms of n launches, each between its own pair of CUDA events
    (on a machine without CUDA, as the CPU tests run a child's checks:
    the host's clock around each call)."""
    for _ in range(warmup):
        fn()
    if not torch.cuda.is_available():
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def check_claims(kernels, args, noise, label, pod_ids=None):
    """Hold the kernel against its plain version on the same inputs;
    returns the max |best| difference over the pods with a claim, and the
    plain version's (claims, best)."""
    got, best = kernels.claims(*args, noise=noise, pod_ids=pod_ids)
    want, want_best = kernels.claims_reference(*args, noise=noise,
                                               pod_ids=pod_ids)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    check(bool(((got == -1) == (want == -1)).all()),
          f"{label} {noise}: pods with no feasible node differ")
    placed = got >= 0
    err = float((best - want_best)[placed].abs().max()) if placed.any() else 0.0
    if noise == "murmur":
        check(bool((got == want).all()) and err == 0.0,
              f"{label} murmur: claims not bit-identical")
    else:
        check(err <= 1e-4, f"{label} sin: best differs by {err}")
        # the plain version's noisy score at the kernel's choice is within
        # 1e-4 of its best: run it with each pod narrowed to that one node
        static = args[0]
        P, N, _R = static["shape"]
        only = torch.zeros_like(static["smask_t"])
        idx = torch.nonzero(placed).squeeze(1)
        only[got[idx].long(), idx] = static["smask_t"][got[idx].long(), idx]
        at, at_best = kernels.claims_reference(
            {**static, "smask_t": only}, *args[1:], noise=noise,
            pod_ids=pod_ids)
        check(bool((at[idx] == got[idx]).all()),
              f"{label} sin: the kernel chose an infeasible node")
        gap = float((at_best[idx] - want_best[idx]).abs().max()) \
            if idx.numel() else 0.0
        check(gap <= 1e-4, f"{label} sin: choice is {gap} below the best")
    print(f"   {label} {noise}: claims agree, max |best err| {err}",
          flush=True)
    return err, want, want_best


def random_claims_case(P, N, seed, dev, R=6, live=0.9, identical=False,
                       same_pods=False, dead_tiles=False):
    """Seeded claims inputs.  identical: every node alike (all cells of a
    pod tie on score); same_pods: every pod requests alike (the kernel's
    shared-fit path); dead_tiles: live pods only at a few scattered
    positions, so most pod tiles of the kernel hold none."""
    rng = np.random.default_rng(seed)
    wide = R != 6
    req = rng.uniform(0, 4, (P, R)).astype(np.float32)
    alloc = rng.uniform(2, 16, (N, R)).astype(np.float32)
    used = rng.uniform(0, 4, (N, R)).astype(np.float32)
    if not wide:
        req[:, 3:] = alloc[:, 3:] = used[:, 3:] = 0
    if identical:
        alloc[:], used[:] = alloc[0], used[0]
        req *= 0.3
    if same_pods:
        req[:] = req[0]
    active = rng.random(P) < live
    if dead_tiles:
        active[:] = False
        active[rng.choice(P, 12, replace=False)] = True
    npods = rng.integers(0, 5, N).astype(np.float32)
    if identical:
        npods[:] = 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    from kubernetes_tpu_torch.ops import kernels
    static = kernels.prepare_static(
        t(req), t(req), t(alloc), t(np.full(N, 4 if wide else 110, np.float32)),
        t(rng.random((N, P)) > 0.25))
    return (static, t(active), t(used), t(used), t(npods))


class ClaimsRecorder:
    """Within the block, every kernels.claims call goes through a wrapper
    that records (pods, live pods, nodes, noise) and a pair of CUDA events
    around the call, and with keep=True a copy of its inputs and of its
    outputs.  With first_live=True it records nothing of the kind: once
    armed with a tag (`armed`), it keeps in kept[tag] a copy of the inputs
    of the first single-device launch with a live pod (finding it reads
    `active` back: a sync per launch until then) and disarms.  The launch
    count stays the package's own (kernels.LAUNCHES)."""

    def __init__(self, kernels, keep=False, first_live=False):
        self.kernels, self.keep, self.rows, self.inputs = kernels, keep, [], []
        self.outputs = []
        self.first_live, self.armed, self.kept = first_live, None, {}

    @staticmethod
    def copy_inputs(static, active, used, used_nz, npods, noise, pod_ids):
        return ({k: v.clone() if torch.is_tensor(v) else v
                 for k, v in static.items()},
                *(t.clone() for t in (active, used, used_nz, npods)),
                noise, None if pod_ids is None else pod_ids.clone())

    def __enter__(self):
        inner = self.inner = self.kernels.claims

        def claims(static, active, used, used_nz, npods, noise="sin",
                   pod_ids=None, node_offset=0):
            args = (static, active, used, used_nz, npods, noise, pod_ids)
            if self.first_live:
                tag = self.armed
                if tag is not None and not node_offset \
                        and bool(active.any()):
                    self.armed = None
                    self.kept[tag] = self.copy_inputs(*args)
                return inner(static, active, used, used_nz, npods,
                             noise=noise, pod_ids=pod_ids,
                             node_offset=node_offset)
            # the kept inputs replay at offset 0: the single device's
            check(not (self.keep and node_offset),
                  "ClaimsRecorder keeps single-device launches only")
            if self.keep:
                self.inputs.append(self.copy_inputs(*args))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.monotonic()
            e0.record()
            out = inner(static, active, used, used_nz, npods, noise=noise,
                        pod_ids=pod_ids, node_offset=node_offset)
            if self.keep:
                self.outputs.append(tuple(t.clone() for t in out))
            e1.record()
            host_ms = (time.monotonic() - t0) * 1e3
            P, N, _R = static["shape"]
            self.rows.append((P, N, noise, active.sum(), e0, e1, host_ms))
            return out
        self.kernels.claims = claims
        return self

    def __exit__(self, *exc):
        self.kernels.claims = self.inner
        return False

    def summary(self, label, smi):
        """Print launches and median ms per (P, N, noise)."""
        torch.cuda.synchronize()
        shapes = {}
        for P, N, noise, live, e0, e1, host_ms in self.rows:
            shapes.setdefault((P, N, noise), []).append(
                (e0.elapsed_time(e1), int(live), host_ms))
        out = {}
        for (P, N, noise), rows in sorted(shapes.items(), reverse=True):
            ms = [r[0] for r in rows]
            live = [r[1] for r in rows]
            out[(P, N, noise)] = (len(rows), statistics.median(ms))
            # the events bracket the wrapper's host work too: the wave
            # loop has just read a count, so the stream is idle meanwhile
            print(f"   {label} claims {P}x{N} {noise}: {len(rows)} launches, "
                  f"median {statistics.median(ms):.4f} ms, min "
                  f"{min(ms):.4f}, max {max(ms):.4f} between events (host "
                  f"time in the wrapper max {max(r[2] for r in rows):.4f} "
                  f"ms); live pods {min(live)}-{max(live)} [{smi}]",
                  flush=True)
        return out


class RecordingBackend:
    """Factory for a TorchBatchBackend that keeps every step's result
    handle (assignments + wave count + generation) and times each step on
    the CUDA stream."""

    @staticmethod
    def make(**kw):
        from kubernetes_tpu_torch.ops.backend import TorchBatchBackend

        class Recording(TorchBatchBackend):
            def __init__(self, **kw):
                super().__init__(**kw)
                self.results = []
                self.step_events = []
                self.step_wall_s = []
                self.encode_s = []
                encode = self.encoder.encode

                def timed_encode(pod_infos):
                    t0 = time.monotonic()
                    batch = encode(pod_infos)
                    self.encode_s.append(time.monotonic() - t0)
                    return batch
                self.encoder.encode = timed_encode

            def _device_step(self, variant, staged, clock=None):
                start = None
                if self.device.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                t0 = time.monotonic()
                res = super()._device_step(variant, staged, clock)
                self.step_wall_s.append(time.monotonic() - t0)
                if start is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.step_events.append((start, end))
                self.results.append(res)
                return res

            def forget_warmup(self):
                """Drop what warmup() recorded: the lists then hold the
                batches' steps only."""
                for rows in (self.results, self.step_events,
                             self.step_wall_s, self.encode_s):
                    rows.clear()

            def step_ms(self):
                torch.cuda.synchronize()
                return [s.elapsed_time(e) for s, e in self.step_events]

        return Recording(**kw)


def build_cluster(n_nodes, seed):
    from kubernetes_tpu_torch.scheduler.cache import Cache
    from kubernetes_tpu_torch.testing import make_node
    cache = Cache()
    # SchedulingBasic's node shape (perf/scheduler_perf.py:514-524); the
    # seed names the run's data, the shape is the workload's
    cache.add_nodes([make_node(f"node-{seed}-{i}")
                     .capacity(cpu="32", mem="256Gi", pods=110).build()
                     for i in range(n_nodes)])
    return cache


def make_batches(n_batches, batch, tag):
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    from kubernetes_tpu_torch.testing import make_pod
    return [[PodInfo(make_pod(f"{tag}-{b}-{i}").req(cpu="100m", mem="128Mi")
                     .build()) for i in range(batch)] for b in range(n_batches)]


def assume(cache, infos, results):
    """The scheduler's batch tail: bulk-assume every placed pod."""
    items = []
    for pi, (name, _st) in zip(infos, results):
        if name:
            pod = {**pi.pod, "spec": {**pi.pod["spec"], "nodeName": name}}
            items.append((pod, pi.clone_with_pod(pod)))
    errs = cache.assume_pods(items)
    check(not any(errs), f"assume failed: {[e for e in errs if e][:3]}")


def drive(cache, batches, device, label, batch, **kw):
    """A path as a scheduler drives it: TorchBatchBackend.warmup(), then
    per batch (a list of PodInfo) assign() against the cache's flatten
    view and the bulk-assume tail.  `kw` go to the backend.  Returns
    (backend, per-batch results, seconds, waves)."""
    from kubernetes_tpu_torch.perf import caps_for_nodes
    t0 = time.monotonic()
    backend = RecordingBackend.make(caps=caps_for_nodes(cache.node_count()),
                                    batch_size=batch, device=device, **kw)
    view = cache.flatten_view()
    backend.prefetch(view)
    backend.warmup()
    backend.forget_warmup()
    print(f"   {label}: setup (flatten, warmup) {time.monotonic() - t0:.3f} "
          f"s; full_cap {backend.full_cap}", flush=True)
    outs, secs, waves = [], [], []
    for infos in batches:
        w0 = backend.stats["waves"]
        t1 = time.monotonic()
        out = backend.assign(infos, view)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.monotonic() - t1)
        waves.append(backend.stats["waves"] - w0)
        assume(cache, infos, out)
        outs.append(out)
    return backend, outs, secs, waves


def verify_placements(cache, outs, n_expected, label):
    from kubernetes_tpu_torch.scheduler.types import ERROR
    counts = {}
    for out in outs:
        for name, st in out:
            check(st is None or st.code != ERROR,
                  f"{label}: ERROR status {st and st.message()}")
            check(name is not None, f"{label}: a pod was not placed: {st}")
            counts[name] = counts.get(name, 0) + 1
    placed = sum(counts.values())
    check(placed == n_expected, f"{label}: placed {placed} of {n_expected}")
    # capacity on the host, from the returned names
    check(max(counts.values()) <= 110, f"{label}: a node holds > 110 pods")
    check(max(counts.values()) * 100 <= 32000, f"{label}: cpu overcommitted")
    check(max(counts.values()) * 128 <= 256 * 1024,
          f"{label}: memory overcommitted")
    print(f"   {label}: {placed} pods placed on {len(counts)} nodes, "
          f"max {max(counts.values())} per node", flush=True)


def profile_batch(backend, cache, label, smi, infos=None, top=8):
    """One more batch under torch.profiler (after the main path's counts
    were read): device time by kernel name and the device's busy share of
    the batch's wall time under the profiler.  `infos` defaults to a batch
    of SchedulingBasic pods.  The full step's stage ranges (record_function
    "full.*") are printed with the device time of the kernels inside them,
    and kept out of the kernel rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if infos is None:
        infos = make_batches(1, backend.batch_size, f"prof-{label}")[0]
    view = cache.flatten_view()
    w0 = backend.stats["waves"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = backend.assign(infos, view)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    check(all(name for name, _ in out), f"{label}: profiled batch unplaced")
    events = prof.key_averages()
    # device-side events only (kernels, copies): an aten op's row repeats
    # the time of the kernels it launched
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in events
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0
                   and not e.key.startswith("full.")), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"   {label} profiled batch: wall {wall_ms:.3f} ms, "
          f"{backend.stats['waves'] - w0} waves, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f} [{smi}]")
    stages = {}
    for e in events:
        if e.key.startswith("full.") and e.device_type == DeviceType.CPU:
            stages[e.key] = (e.device_time_total / 1e3, e.count,
                             e.cpu_time_total / 1e3)
    for key, (ms, count, cpu_ms) in sorted(stages.items()):
        print(f"     stage {key}: device {ms:10.3f} ms in x{count} ranges "
              f"(host {cpu_ms:.3f} ms)")
    for ms, count, key in rows[:top]:
        print(f"     {ms:10.3f} ms  x{count:<5d} {key[:90]}")


# -- the full (constraint) variant: scheduler_perf's constraint workloads --

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
ZONES = ("zone-a", "zone-b", "zone-c")


def build_zoned_cluster(n_nodes, seed, disk_labels=False):
    """scheduler_perf's createNodes with zones (scheduler_perf.py:514-538):
    32 CPU, 256Gi, 110 pods, zone = zones[i % 3], hostname = the node's
    name; with disk_labels every other node is disk=ssd."""
    from kubernetes_tpu_torch.scheduler.cache import Cache
    from kubernetes_tpu_torch.testing import make_node
    cache = Cache()
    nodes = []
    for i in range(n_nodes):
        name = f"node-{seed}-{i}"
        w = (make_node(name).capacity(cpu="32", mem="256Gi", pods=110)
             .labels(**{HOST: name}).zone(ZONES[i % 3]))
        if disk_labels:
            w.labels(disk="ssd" if i % 2 == 0 else "hdd")
        nodes.append(w.build())
    cache.add_nodes(nodes)
    return cache


def spread_pod(name, max_skew):
    """TopologySpreading's pod (performance-config.yaml:36-50)."""
    from kubernetes_tpu_torch.testing import make_pod
    return (make_pod(name).req(cpu="100m", mem="128Mi").labels(app="spread")
            .topology_spread(ZONE, max_skew=max_skew,
                             match_labels={"app": "spread"}).build())


def anti_pod(name):
    """SchedulingPodAntiAffinity's pod (performance-config.yaml:56-71)."""
    from kubernetes_tpu_torch.testing import make_pod
    return (make_pod(name).req(cpu="100m", mem="128Mi").labels(app="anti")
            .pod_affinity(HOST, {"app": "anti"}, anti=True).build())


def mixed_pod(name, i):
    """Phase (a)'s mix: hard zone spread, hostname anti-affinity, node
    affinity and host ports, pod by pod."""
    from kubernetes_tpu_torch.testing import make_pod
    k = i % 4
    if k == 0:
        return spread_pod(name, 1)
    if k == 1:
        return anti_pod(name)
    w = make_pod(name).req(cpu="200m", mem="256Mi")
    if k == 2:
        return w.node_affinity_in("disk", ["ssd"]).build()
    return w.host_port(8000 + i % 8).build()


def check_constraints(cache, outs, label, max_skew=None, anti=False):
    """Zone skew of the placed pods within max_skew, and no two
    anti-affinity pods on one node, from the returned names."""
    from kubernetes_tpu_torch.scheduler.cache import Snapshot
    zone = {ni.name: ni.node["metadata"]["labels"].get(ZONE)
            for ni in cache.update_snapshot(Snapshot()).list()}
    names = [name for out in outs for name, _st in out]
    if max_skew is not None:
        per_zone = {z: 0 for z in ZONES}
        for name in names:
            per_zone[zone[name]] += 1
        skew = max(per_zone.values()) - min(per_zone.values())
        check(skew <= max_skew, f"{label}: zone skew {skew} > {max_skew} "
                                f"({per_zone})")
        print(f"   {label}: pods per zone {per_zone}, skew {skew} <= "
              f"{max_skew}", flush=True)
    if anti:
        check(len(set(names)) == len(names),
              f"{label}: two anti-affinity pods share a node")
        print(f"   {label}: {len(names)} anti-affinity pods on "
              f"{len(set(names))} distinct nodes", flush=True)


# phase -> (nodes, pods per batch) for (a); (nodes, pods per batch,
# batches, batch size) for (b)-(d)
FULL_SIZES = {"a": (5000, 1024), "b": (1000, 5000, 1, 8192),
              "c": (5000, 5000, 1, 8192), "d": (100_000, 8192, 2, 8192)}


def full_variant_phases(dev, smi, sizes=FULL_SIZES):
    """Phases (a)-(d).  The claims count is zeroed before each and read
    after it: the full variant reaches no hand kernel, so it stays 0."""
    from kubernetes_tpu_torch.models import carry
    from kubernetes_tpu_torch.ops import backend as port_backend
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.types import ERROR, PodInfo

    with Phase("a full variant GPU vs CPU"):
        runs = []
        for device in (dev, torch.device("cpu")):
            kernels.LAUNCHES["claims"] = 0
            n_nodes, batch = sizes["a"]
            cache = build_zoned_cluster(n_nodes, 3, disk_labels=True)
            batches = [[PodInfo(mixed_pod(f"a{b}-{i}", i))
                        for i in range(batch)] for b in range(2)]
            backend, outs, secs, waves = drive(
                cache, batches, device, f"full-{device.type}", batch)
            check(kernels.LAUNCHES["claims"] == 0,
                  "full variant: the claims kernel launched")
            check(all(st is None or st.code != ERROR for out in outs
                      for _n, st in out), "full variant: ERROR status")
            state, _ = carry.state_to_numpy(backend._state)
            runs.append(([r.get().copy() for r in backend.results], state,
                         waves))
            print(f"   full-{device.type}: batch wall s "
                  f"{[round(x, 4) for x in secs]}; waves per batch {waves}; "
                  f"placed {sum(1 for o in outs for n, _ in o if n)} of "
                  f"{2 * batch} [{smi}]", flush=True)
        g, c = runs
        check(len(g[0]) == len(c[0]) and all(
            np.array_equal(a, b) for a, b in zip(g[0], c[0])),
            "full variant: GPU and CPU result vectors differ: " + "; ".join(
                f"vector {i} slots {d[:8].tolist()} GPU {a[d[:8]].tolist()}"
                f" CPU {b[d[:8]].tolist()}"
                for i, (a, b) in enumerate(zip(g[0], c[0]))
                for d in [np.nonzero(a != b)[0]] if d.size))
        for k in g[1]:
            check(np.array_equal(g[1][k], c[1][k]),
                  f"full variant: final state {k} differs")
        print(f"   {len(g[0])} result vectors and the final state (cd_sg, "
              f"cd_asg included) are bit-identical; waves per batch {g[2]}",
              flush=True)
        del runs, g, c, backend

    for tag, label, make, skew, anti in (
            ("b", "TopologySpreading", lambda nm: spread_pod(nm, 5), 5,
             False),
            ("c", "SchedulingPodAntiAffinity", anti_pod, None, True),
            ("d", "spread-100k", lambda nm: spread_pod(nm, 5), 5, False)):
        n_nodes, n_pods, n_batches, batch = sizes[tag]
        with Phase(f"{tag} {label} {n_nodes} nodes"):
            # earlier phases' backends sit in reference cycles: collect
            # them, so the base holds only what is still live
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.LAUNCHES["claims"] = 0
            cache = build_zoned_cluster(n_nodes, 5)
            batches = [[PodInfo(make(f"{tag}{b}-{i}")) for i in range(n_pods)]
                       for b in range(n_batches)]
            backend, outs, secs, waves = drive(cache, batches, dev, label,
                                               batch)
            check(kernels.LAUNCHES["claims"] == 0,
                  f"{label}: the claims kernel launched")
            verify_placements(cache, outs, n_pods * n_batches, label)
            check_constraints(cache, outs, label, skew, anti)
            print(f"   {label}: batch wall s {[round(x, 4) for x in secs]}; "
                  f"waves per batch {waves}; {backend.stats['batches']} "
                  f"batches; step span on the CUDA stream ms "
                  f"{[round(x, 3) for x in backend.step_ms()]} [{smi}]",
                  flush=True)
            peak = torch.cuda.max_memory_allocated()
            cells = backend.full_cap * backend.caps.n_cap
            per_cell = (peak - base) / cells
            print(f"   {label}: full_cap {backend.full_cap}; peak allocated "
                  f"{peak} B, {peak - base} B above the phase's start: "
                  f"{per_cell:.3f} B per (pod, node row) cell of "
                  f"{backend.full_cap} x {backend.caps.n_cap} (the sizing "
                  f"rule plans {port_backend.FULL_BYTES_PER_CELL}) [{smi}]",
                  flush=True)
            if tag == "d":
                # the phase whose full_cap the card's memory sizes (at
                # 1,000 and 5,000 nodes the 4,096 ceiling binds first, and
                # a step's bounded chunk of [rows, N] temporaries dominates)
                check(per_cell <= port_backend.FULL_BYTES_PER_CELL,
                      f"{label}: {per_cell:.3f} B per cell exceeds the "
                      f"sizing rule's {port_backend.FULL_BYTES_PER_CELL}")
                profile_batch(backend, cache, label, smi, infos=[
                    PodInfo(spread_pod(f"prof-{i}", 5))
                    for i in range(n_pods)], top=15)
            del backend, cache, outs, batches


# -- batched preemption: the dry-run kernel and preempt_batch --------------

PLANES = ("cand", "viol", "highest", "psum", "nvic", "victim words",
          "overflow_hit")
# (generator, arguments).  "random" (P, N, V, R, G, T, seed): ragged N, P
# of 1 / 37 / 256, V of 8 / 16, R of 5 / 6 / 8, one to three groups, taints
# past one 32-bit word; "flat" (P, N, V, R, T, seed, lead): slots as
# ops/flatten.py writes them, pods from a few templates (flat_dry_run_case)
DRY_RUN_CASES = [("random", (1, 1000, 8, 5, 1, 4, 1)),
                 ("random", (37, 5003, 16, 6, 2, 31, 2)),
                 ("random", (256, 20000, 16, 8, 3, 16, 3)),
                 ("random", (256, 1000, 8, 6, 1, 40, 4)),
                 ("random", (37, 20000, 16, 5, 3, 31, 5)),
                 ("random", (1, 5003, 16, 8, 2, 16, 6)),
                 ("random", (256, 5003, 16, 6, 1, 64, 7)),
                 ("flat", (256, 20000, 16, 6, 16, 12, 0)),
                 ("flat", (200, 5003, 32, 5, 40, 13, 0)),
                 ("flat", (130, 1000, 16, 6, 16, 14, 0)),
                 ("flat", (256, 5003, 16, 6, 16, 17, 70))]


def random_dry_run_case(P, N, V, R, G, T, seed, dev):
    """Seeded dry-run inputs in models/preempt.py's argument order: PAD
    slots, PDB bits, overflow rows, 0/1 taints, G groups of nominations,
    inactive pods, and priorities at the clamp bounds and above 2^24."""
    rng = np.random.default_rng(seed)
    f = np.float32
    i32_max = 2**31 - 1
    vprio = rng.integers(-5, 20, (N, V)).astype(np.int32)
    vprio[rng.random((N, V)) < 0.1] = rng.integers(2**25, i32_max - 2)
    vprio[rng.random((N, V)) < 0.05] = -i32_max + 1
    vprio[rng.random((N, V)) < 0.3] = i32_max
    prio = rng.integers(0, 25, P).astype(np.int32)
    prio[rng.random(P) < 0.1] = rng.integers(2**25, i32_max - 1)
    prio[rng.random(P) < 0.2] = i32_max - 1
    args = (rng.integers(1, 9, (N, R)).astype(f) * 1000,
            rng.integers(0, 8, (N, R)).astype(f) * 500,
            rng.integers(0, 6, N).astype(f), rng.integers(3, 10, N).astype(f),
            rng.random(N) < 0.9, (rng.random((N, T)) < 0.2).astype(f), vprio,
            rng.integers(0, 6, (N, V, R)).astype(f) * 300,
            (rng.random((N, V)) < 0.3).astype(f), rng.random(N) < 0.05,
            (rng.integers(0, 3, (G, N, R)) * 400).astype(f),
            rng.integers(0, 2, (G, N)).astype(f),
            rng.integers(0, G, P).astype(np.int32),
            (rng.integers(0, 8, (P, R)) * 400).astype(f), prio,
            (rng.random((P, T)) < 0.3).astype(f), rng.random(P) < 0.85)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]


def flat_dry_run_case(P, N, V, R, T, seed, lead, dev, live=None,
                      one_key=False):
    """Dry-run inputs shaped as ops/flatten.py writes them: each node's
    slots ascending by priority, PAD (I32_MAX, request 0, no PDB bit) at
    the tail, invalid rows all PAD, overflow only on full rows; nodes with
    no live slot and with all V; equal-priority slots split by their PDB
    bit.  The pods come from five templates, each pod's group the rank of
    its priority: two of one priority with different requests
    alternating, then three whose keys change pod to pod, then a run of
    one template across the 64-pod block edge with inactive pods inside,
    then a seeded mix; pod priorities between the slots' make only a
    prefix eligible; `lead` pods of the first template (no untolerated
    taint) go first.  live=k gives every valid node k live slots;
    one_key=True makes every pod the first template (one priority, one
    group, one request), as a wave of one workload's replicas."""
    rng = np.random.default_rng(seed)
    f = np.float32
    i32_max = 2**31 - 1
    k = rng.integers(0, V + 1, N) if live is None else np.full(N, live)
    if live is None:
        k[:3], k[3:6] = 0, V
    valid = rng.random(N) < 0.9
    valid[:6] = True
    k[~valid] = 0
    levels = np.array([-3, 0, 2, 5, 8, 2**25 + 3, 2**26 + 1], np.int32)
    vprio = np.sort(rng.choice(levels, (N, V), p=[.1, .3, .15, .2, .1, .1,
                                                   .05]), axis=1)
    pad = np.arange(V)[None] >= k[:, None]
    vprio[pad] = i32_max
    vreq = rng.integers(0, 6, (N, V, R)).astype(f) * 250
    vreq[pad] = 0
    vpdb = ((rng.random((N, V)) < 0.4) & ~pad).astype(f)
    over = (k == V) & (rng.random(N) < 0.2)
    npods = (k + rng.integers(0, 3, N)).astype(f)
    maxpods = npods + rng.integers(0, 4, N).astype(f)
    taint = (rng.random((N, T)) < 0.2) & (rng.random((N, 1)) < 0.3)
    tpl_prio = np.array([10 if one_key else 6, 6, 1, 9, 2**26 + 7], np.int32)
    tpl_req = (rng.integers(0, 8, (5, R)) * 400).astype(f)
    tpl_untol = rng.random((5, T)) < 0.2
    tpl_untol[:3] = False
    if one_key:
        seq = np.zeros(P, np.int64)
        active = np.ones(P, bool)
    else:
        seq = ([0] * lead + [i % 2 for i in range(20)]
               + [(3, 4, 2)[i % 3] for i in range(20)] + [0] * 60)
        seq = np.array((seq + list(rng.integers(0, 5, P)))[:P])
        active = rng.random(P) < 0.9
        active[[i + lead for i in (45, 63, 64, 70) if i + lead < P]] = False
    prio = tpl_prio[seq]
    groups = np.unique(prio)
    G = len(groups)
    args = (rng.integers(2, 9, (N, R)).astype(f) * 1000,
            rng.integers(0, 8, (N, R)).astype(f) * 500, npods, maxpods,
            valid, taint.astype(f), vprio, vreq, vpdb, over,
            (rng.integers(0, 3, (G, N, R)) * 400
             * (rng.random((G, N, 1)) < 0.3)).astype(f),
            (rng.integers(0, 2, (G, N))
             * (rng.random((G, N)) < 0.3)).astype(f),
            np.searchsorted(groups, prio).astype(np.int32), tpl_req[seq],
            prio, tpl_untol[seq].astype(f), active)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]


def check_dry_run(preempt, args, label, k_cap=None):
    """The kernel (dry_run_planes on the card) against the plain version on
    the same inputs, its victims packed the same way: every plane bit for
    bit.  Returns the max |difference| over the float and int planes and
    the kernel's planes."""
    got = preempt.dry_run_planes(*args, k_cap=k_cap)
    ref = preempt.preempt_dry_run_reference(*args)
    want = (*ref[:5], preempt.pack_bits(ref[5])[..., 0], ref[6])
    torch.cuda.synchronize()
    for name, g, w in zip(PLANES, got, want):
        check(g.dtype == w.dtype and bool(torch.equal(g, w)),
              f"{label}: {name} differs from the plain version "
              f"({int((g != w).sum())} cells)")
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got[1:6], want[1:6]))
    full = preempt.preempt_dry_run(*args)
    check(bool(torch.equal(full[5], ref[5])),
          f"{label}: the expanded victims differ")
    P, N = got[0].shape
    print(f"   {label}: {P}x{N} V={args[6].shape[1]} R={args[0].shape[1]} "
          f"G={args[10].shape[0]} T={args[5].shape[1]}: all planes "
          f"bit-identical; candidates {int(got[0].sum())}, victims "
          f"{int(ref[5].sum())}, overflow pods {int(got[6].sum())}",
          flush=True)
    return err, got


def time_cuda_run(fn, n: int, warmup: int = 2) -> float:
    """ms per launch of n launches back to back between one pair of CUDA
    events: the device's time when the host enqueues faster than it runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def time_dry_run(preempt, args, k_cap, planes, label, smi, others=None):
    """The dry-run kernel at one shape: the wrapper (dry_run_planes, each
    call between its own events, median of 20), the bare launch
    (prepared_launch: checks and allocations once, 20 launches back to
    back) on the kernel's own grid and on both grids it chooses from (a
    block walks all pods, or 64-pod ranges), the same planes written by
    fill_ (the store rate's yardstick), the plain version, the bound and
    the launch shape on this card; then each other revision's wrapper in
    turns with this one's (this, other, other, this) after checking its
    planes.  Every bare launch's planes are checked against `planes`."""
    P, N = planes[0].shape

    def bare(**kw):
        launch, out = preempt.prepared_launch(*args, k_cap=k_cap, **kw)
        ms = time_cuda_run(launch, 20)
        check(all(bool(torch.equal(g, w)) for g, w in zip(out, planes)),
              f"{label}: the bare launches' planes differ ({kw})")
        return ms, out

    def ours():
        return preempt.dry_run_planes(*args, k_cap=k_cap)
    ms = time_cuda(ours, 20)
    launch_ms, out = bare()
    grid_ms = {ppb: bare(pods_per_block=ppb)[0] for ppb in (P, 64)}
    fill_ms = time_cuda_run(lambda: [x.fill_(0) for x in out], 20)
    plain_ms = time_cuda(
        lambda: preempt.preempt_dry_run_reference(*args), 3, warmup=1)
    (bound_ms, by), nbytes, ops = dry_run_bound(args, planes)
    occ = preempt.kernel_occupancy(args[0].shape[1], args[5].shape[1], k_cap)
    print(f"   {label} {P}x{N} (k_cap {k_cap}): dry_run_planes {ms:.4f} ms "
          f"(median of 20), bare launch {launch_ms:.4f} ms (20 back to "
          f"back; a block walking all {P} pods {grid_ms[P]:.4f} ms, 64-pod "
          f"ranges {grid_ms[64]:.4f} ms), fill_ of the same planes "
          f"{fill_ms:.4f} ms, plain version {plain_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({by}: {nbytes} bytes, {ops} operations), "
          f"{bound_ms / launch_ms:.4f} of it; registers "
          f"{occ['registers']}, spill {occ['spill_bytes']} B, shared "
          f"{occ['smem_bytes']} B a block of {occ['block_rows']} rows, "
          f"{occ['blocks_per_sm']} blocks ({occ['warps_per_sm']} warps) an "
          f"SM [{smi}]", flush=True)
    for tag, other in (others or {}).items():
        kw = ({"k_cap": k_cap} if "k_cap" in
              inspect.signature(other.dry_run_planes).parameters else {})

        def theirs(other=other, kw=kw):
            return other.dry_run_planes(*args, **kw)
        got = theirs()
        torch.cuda.synchronize()
        check(all(bool(torch.equal(g, w)) for g, w in zip(got, planes)),
              f"{label}: revision {tag}'s dry run disagrees with this one")
        t = [time_cuda(fn, 10) for fn in (ours, theirs, theirs, ours)]
        print(f"   {label} dry_run_planes A/B this vs {tag}: this "
              f"{t[0]:.4f} {t[3]:.4f} ms, {tag} {t[1]:.4f} {t[2]:.4f} ms "
              f"[{smi}]", flush=True)
    return {"ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "occupancy": occ}


def candidates_bound(args, rows):
    """(ms, bound_by, bytes, ops) for one K8 preempt_candidates call: each
    input read once and the rows and counts written once over HBM
    bandwidth, against its operations over the FP32 peak: per (pod, node)
    cell R subtracts, adds, compares, clamps, divides and headroom adds
    (6R) and ~12 for the pod-count test, masks, score and hash; the top-k
    selection counted as one compare a cell."""
    P, R = args[8].shape
    N = args[0].shape[0]
    nbytes = (sum(a.numel() * a.element_size() for a in args)
              + rows[0].numel() * 4 + rows[1].numel() * 4)
    ops = P * N * (6 * R + 12 + 1)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_OPS_PER_S * 1e3
    return ((t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes"),
            t_bytes, nbytes, ops)


def dry_run_phase(dev, smi, others=None):
    """Phase e: the dry-run kernel against its plain version on seeded
    cases, then both timed at the 100k chunk shape (P=256 x N=110,080) on
    random slots and on flatten-shaped ones (one key, 4 live slots a
    node), and K8 (torch) timed at the same shape; `others` maps a tag to
    another revision's models.preempt, timed beside this one's there."""
    from kubernetes_tpu_torch.models import preempt
    from kubernetes_tpu_torch.perf import caps_for_nodes
    with Phase("e preempt dry-run kernel vs plain version"):
        errs = []
        for kind, shape in DRY_RUN_CASES:
            if kind == "random":
                args = random_dry_run_case(*shape, dev)
            else:
                args = flat_dry_run_case(*shape, dev)
            errs.append(check_dry_run(preempt, args,
                                      f"{kind} case {shape[-1]}")[0])
        caps = caps_for_nodes(100_000)
        for label, args in (
                ("100k random", random_dry_run_case(
                    256, caps.n_cap, caps.v_cap, caps.r, 1, caps.t_cap, 11,
                    dev)),
                ("100k flatten-shaped", flat_dry_run_case(
                    256, caps.n_cap, caps.v_cap, caps.r, caps.t_cap, 15, 0,
                    dev, live=4, one_key=True))):
            k_cap = preempt.live_slot_cap(args[6].cpu().numpy())
            err, planes = check_dry_run(preempt, args, label, k_cap)
            errs.append(err)
            time_dry_run(preempt, args, k_cap, planes, label, smi, others)
            del args, planes
        check(max(errs) == 0.0, f"dry run: max |err| {max(errs)}")
        # K8, the legacy tier's candidate rows (plain torch), at the chunk
        # shape: seeded inputs, one group, k = 16
        rng = np.random.default_rng(16)
        N, R, P = caps.n_cap, caps.r, 256
        f = np.float32
        alloc = rng.integers(1, 9, (N, R)).astype(f) * 1000
        kargs = [torch.from_numpy(a).to(dev) for a in (
            alloc, (alloc * rng.uniform(0.5, 1.0, (N, R))).astype(f),
            rng.integers(0, 8, N).astype(f), rng.integers(4, 10, N).astype(f),
            rng.random(N) < 0.95,
            (rng.integers(0, 4, (1, N, R)) * 350).astype(f),
            rng.integers(0, 4, (1, N)).astype(f), np.zeros(P, np.int32),
            (rng.integers(0, 6, (P, R)) * 500).astype(f), np.ones(P, bool))]
        rows = preempt.preempt_candidates(*kargs, 16)
        k8_ms = time_cuda(lambda: preempt.preempt_candidates(*kargs, 16), 5)
        (k8_bound, k8_by), k8_bytes_ms, k8_bytes, k8_ops = candidates_bound(
            kargs, rows)
        print(f"   K8 preempt_candidates {P}x{N} k=16 (torch): {k8_ms:.4f} ms "
              f"(median of 5); bound {k8_bound:.4f} ms ({k8_by}: {k8_ops} "
              f"operations; bytes bound {k8_bytes_ms:.6f} ms, {k8_bytes} "
              f"bytes); feasible per pod {int(rows[1].float().mean())} "
              f"[{smi}]", flush=True)
        del kargs, rows


def build_preempt_cluster(n_nodes, per_node, seed):
    """PreemptionBasic's shape (performance-config.yaml:359-384): 4 CPU,
    32Gi nodes, each holding `per_node` priority-0 pods of 900m / 500Mi,
    added to the cache as bound pods."""
    from kubernetes_tpu_torch.scheduler.cache import Cache
    from kubernetes_tpu_torch.testing import make_node, make_pod
    cache = Cache()
    cache.add_nodes([make_node(f"node-{seed}-{i}")
                     .capacity(cpu="4", mem="32Gi").build()
                     for i in range(n_nodes)])
    tpl = make_pod("tpl").req(cpu="900m", mem="500Mi").build()
    pods = []
    for i in range(n_nodes):
        for k in range(per_node):
            name = f"low-{i}-{k}"
            pods.append({**tpl, "metadata": {**tpl["metadata"], "name": name,
                                             "uid": f"uid-{name}"},
                         "spec": {**tpl["spec"],
                                  "nodeName": f"node-{seed}-{i}"}})
    cache.confirm_or_add_pods(pods)
    return cache


def check_preemptions(snap, pre, results, order, label):
    """Every result by arithmetic, along the wave's order: its victims are
    pods of its node with lower priority than the preemptor, and with them
    (and every earlier winner's victims there) evicted the preemptor fits
    the node's CPU, memory and pod count with the earlier winners on that
    node charged.  Returns (winners, victims)."""
    evicted: dict[str, set] = {}
    charged: dict[str, list] = {}
    winners = victims = 0
    for i in order:
        if results[i] is None:
            continue
        node, vkeys, _viol = results[i]
        ni = snap.get(node)
        pods = {p.key: p for p in ni.pods}
        for k in vkeys:
            check(k in pods, f"{label}: victim {k} is not on {node}")
            check(pods[k].priority < pre[i].priority,
                  f"{label}: victim {k} is not of lower priority")
        gone = evicted.setdefault(node, set())
        gone.update(vkeys)
        rest = [p for k, p in pods.items() if k not in gone]
        cpu = sum(p.request.milli_cpu for p in rest)
        mem = sum(p.request.memory for p in rest)
        for c in charged.get(node, ()):
            cpu += c.request.milli_cpu
            mem += c.request.memory
        count = len(rest) + len(charged.get(node, ())) + 1
        a = ni.allocatable
        check(cpu + pre[i].request.milli_cpu <= a.milli_cpu
              and mem + pre[i].request.memory <= a.memory
              and count <= a.allowed_pod_number,
              f"{label}: {pre[i].key} does not fit {node} after eviction")
        charged.setdefault(node, []).append(pre[i])
        winners += 1
        victims += len(vkeys)
    return winners, victims


def preempt_phase(dev, smi, n_nodes=100_000, per_node=4, n_pre=512,
                  others=None):
    """Phase f: one wave of n_pre priority-10 preemptors (3000m, 500Mi)
    through TorchBatchBackend.preempt_batch against n_nodes nodes of
    PreemptionBasic's shape holding per_node residents each.  The preempt
    count is zeroed just before the wave and read just after.  Returns the
    kernel's numbers for the kernels line (its first chunk's inputs);
    `others` as in dry_run_phase."""
    from kubernetes_tpu_torch.models import preempt
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.scheduler.cache import Snapshot
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    from kubernetes_tpu_torch.testing import make_pod

    class Recording(TorchBatchBackend):
        """Times each chunk: the dry run between CUDA events (synchronised
        after, so the pull that follows measures the copy alone), the pull
        and the host work after it on the host clock."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.marks = []
            self.vict_s = []

        def _ensure_vict(self):
            t0 = time.monotonic()
            super()._ensure_vict()
            self.vict_s.append(time.monotonic() - t0)

        def _preempt_step(self, body):
            t0 = time.monotonic()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = super()._preempt_step(body)
            e1.record()
            torch.cuda.synchronize()
            self.marks.append({"start": t0, "events": (e0, e1)})
            return out

        def _pull(self, *planes):
            t0 = time.monotonic()
            out = super()._pull(*planes)
            self.marks[-1]["pull_s"] = time.monotonic() - t0
            self.marks[-1]["pulled"] = time.monotonic()
            return out

    with Phase(f"f preempt_batch {n_nodes} nodes"):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        cache = build_preempt_cluster(n_nodes, per_node, 9)
        snap = cache.update_snapshot(Snapshot())
        t_cluster = time.monotonic() - t0
        backend = Recording(caps=caps_for_nodes(n_nodes), batch_size=1024,
                            device=dev)
        backend.prefetch(cache.flatten_view())
        t1 = time.monotonic()
        backend.warmup()
        t_warm = time.monotonic() - t1
        print(f"   cluster of {n_nodes} nodes and {n_nodes * per_node} "
              f"resident pods {t_cluster:.3f} s; warmup (build, victim "
              f"tensors, first dry run) {t_warm:.3f} s; victim occupancy "
              f"{backend.victim_occupancy():.4f}", flush=True)
        pre = [PodInfo(make_pod(f"pre-{j}").priority(10)
                       .req(cpu="3000m", mem="500Mi").build())
               for j in range(n_pre)]
        node_ord_of = {ni.name: i for i, ni in enumerate(snap.list())}
        backend.marks.clear()
        captured = []
        inner = preempt.dry_run_planes

        def capture(*args, **kw):
            if not captured:
                captured.append(([a.clone() for a in args], kw))
            return inner(*args, **kw)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        backend.vict_s.clear()
        # the interpreter's collections inside the wave (400,000 resident
        # pods' objects are live)
        collections = []

        def on_gc(phase, info):
            collections.append((phase, info["generation"], time.monotonic()))
        kernels.LAUNCHES["preempt"] = 0
        preempt.dry_run_planes = capture
        gc.callbacks.append(on_gc)
        try:
            t2 = time.monotonic()
            results, esc = backend.preempt_batch(pre, node_ord_of)
            wall = time.monotonic() - t2
        finally:
            preempt.dry_run_planes = inner
            gc.callbacks.remove(on_gc)
        gc_ms = {}
        for (ph0, gen, t_a), (_ph1, _g, t_b) in zip(collections[::2],
                                                    collections[1::2]):
            gc_ms[gen] = gc_ms.get(gen, 0.0) + (t_b - t_a) * 1e3
        launches = kernels.LAUNCHES["preempt"]
        peak = torch.cuda.max_memory_allocated()
        check(launches == -(-n_pre // backend.PREEMPT_P_CAP),
              f"preempt_batch: {launches} dry-run launches")
        check(not esc, f"preempt_batch: escapes {esc}")
        winners, victims = check_preemptions(
            snap, pre, results, backend.last_wave_order, "preempt_batch")
        check(winners == n_pre, f"preempt_batch: {winners} of {n_pre} won")
        ends = [m["start"] for m in backend.marks[1:]] + [t2 + wall]
        kernel_ms = [m["events"][0].elapsed_time(m["events"][1])
                     for m in backend.marks]
        pull_ms = [m["pull_s"] * 1e3 for m in backend.marks]
        select_ms = [(e - m["pulled"]) * 1e3
                     for m, e in zip(backend.marks, ends)]
        before_ms = (backend.marks[0]["start"] - t2) * 1e3
        busy = sum(kernel_ms) + sum(pull_ms)
        print(f"   wave of {n_pre} preemptors: wall {wall * 1e3:.3f} ms; "
              f"before the first chunk (gates, victim refresh, host "
              f"copies, reprieve order) {before_ms:.3f} ms; per chunk: dry "
              f"run between events {[round(x, 4) for x in kernel_ms]} ms, "
              f"pull {[round(x, 3) for x in pull_ms]} ms, host selection "
              f"{[round(x, 3) for x in select_ms]} ms; device busy (dry "
              f"runs + pulls) {busy:.3f} ms, idle share "
              f"{1 - busy / (wall * 1e3):.4f}; victim refresh "
              f"{sum(backend.vict_s) * 1e3:.3f} ms; the interpreter's "
              f"collections ms by generation {gc_ms} [{smi}]", flush=True)
        print(f"   {winners} winners on {len({r[0] for r in results if r})} "
              f"nodes, {victims} victims, escapes {len(esc)}, dry-run "
              f"launches {launches}, victim occupancy "
              f"{backend.victim_occupancy():.4f}; peak device memory "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB "
              f"above the wave's start) [{smi}]", flush=True)
        # the first chunk's inputs and the k_cap the backend passed: the
        # kernel against the plain version, then timed
        args, kw = captured[0]
        k_cap = kw["k_cap"]
        check(k_cap == preempt.live_slot_cap(args[6]),
              f"the backend's k_cap {k_cap} is not the slots' live cap")
        err, planes = check_dry_run(preempt, args, "first chunk", k_cap)
        timed = time_dry_run(preempt, args, k_cap, planes, "first chunk",
                             smi, others)
        del backend, cache, snap, captured, args, planes
        return {"launches": launches, "max_abs_err": err, **timed}


# -- the scheduler loop: perf.bench configs through a real Scheduler -------

# phase -> bench config (kubernetes_tpu_torch/perf/bench.py CONFIGS)
LOOP_PHASES = (("8", "SchedulingBasic"), ("9", "Scheduling100k"),
               ("10", "SchedulingBasicPaced"), ("11", "PreemptionBasic"),
               ("12", "PreemptionDense"),
               ("13", "SchedulingPodAntiAffinity"),
               ("14", "SchedulingHighCardinality"),
               ("15", "TopologySpreading"), ("16", "CoschedulingGang"),
               ("17", "SchedulingHostNull"),
               ("18", "SchedulingOverloadFlood"),
               ("19", "SchedulingChurnStorm"))
# rows whose pods carry placement rules: every batch runs the full
# variant, which reaches no hand kernel
CONSTRAINT_ROWS = ("SchedulingPodAntiAffinity", "SchedulingHighCardinality",
                   "TopologySpreading")
# the profiled batch of a row whose pods are not SchedulingBasic's
PROFILED_PODS = 4096
# phase 17: nulled and card runs at SchedulingBasic's depth, in turns (one
# round: two made the script too long for its 1,200 s limit)
HOST_CEILING_ROUNDS = 1
# one pass a row on the card, where bench.py's two_pass rows run two: the
# script's time limit (the pass bench.py would keep is the better of two)
ROW_PASSES = 1


def profile_loop_batch(cluster, batch, label, smi, top=8, op=None):
    """One more batch through the running Scheduler (after the measured
    window and the launch count were read) under torch.profiler
    (perf.bench.profile_batch): wall from the create to the last
    scheduling attempt, device busy time of the kernels and copies in it,
    and the device's idle share.  The batch is `batch` pods of
    SchedulingBasic's shape, which must all bind, or of the createPods op
    `op` (a workload's measured pods).  The loop's threads launch the
    kernels; CUPTI records every launch of the process.  Returns the idle
    share."""
    from kubernetes_tpu_torch.perf import bench
    got = bench.profile_batch(cluster, batch, label, op=op)
    check(got["done"], f"{label}: the profiled batch was not "
                       f"{'bound' if op is None else 'attempted'} within "
                       f"120 s")
    print(f"   {label} profiled loop batch ({got['pods']} pods, create to "
          f"last attempt): wall {got['wall_ms']:.3f} ms, {got['waves']} "
          f"waves, {got['events']} device events, device busy "
          f"{got['busy_ms']:.3f} ms, idle share {got['idle_share']:.4f} "
          f"[{smi}]", flush=True)
    for ms, count, key in got["top"][:top]:
        print(f"     {ms:10.3f} ms  x{count:<5d} {key[:90]}")
    return got["idle_share"]


def pass_escapes(cluster):
    """A pass's dispatch escapes: the backend's count, by reason as the
    scheduler's escape counter has them."""
    sched = cluster.scheduler
    sched.expose_metrics()
    backend = sched.profiles["default-scheduler"].batch_backend
    by_reason = sched.metrics.prom.tpu_escape_total.values()
    return {"escaped": backend.stats.get("escaped", 0),
            "by_reason": {"/".join(k): v for k, v in by_reason.items()}}


def check_pass(name, cfg, res, seen, smi, preempting, marked):
    """The invariants of one pass of a row (run_once's result, and what
    the `after` hook saw): the barrier held, every pod bound (preemption
    victims are deleted), none on a node over its CPU, memory or 110-pod
    cap (the storm's drained nodes aside), no ERROR status; the escape
    rate is 0, except that the rows whose workload marks pods the tensor
    path does not encode (escapeEvery) or whose chaos injects all-escape
    waves must escape; the claims kernel launched in this pass where its
    batches are plain, nothing on the nulled device; the preemption rows
    bind every high-priority pod and launch the preempt kernel for every
    dry-run chunk; the chaos and the storm fired and no pod was bound
    twice under the storm."""
    label = f"{name} pass {seen['pass']}"
    check("error" not in res, f"{label}: {res.get('error')}")
    check(res["stats"].get("barrier_ok"), f"{label}: barrier failed")
    d = res["detail"]
    placed = d["placements"]
    created = res["stats"]["created_pods"]
    check(placed["bound"] == placed["pods"] == created - placed["deleted"]
          and (preempting or placed["deleted"] == 0),
          f"{label}: {placed['bound']} of {placed['pods']} pods bound "
          f"({created} created, {placed['deleted']} deleted)")
    check(placed["nodes_over_capacity"] == 0
          and placed["max_pods_per_node"] <= 110,
          f"{label}: nodes over capacity {placed['over_examples']}")
    check(d["schedule_attempts"]["error"] == 0,
          f"{label}: ERROR statuses {d['schedule_attempts']}")
    esc = d.get("escape_rate", 0.0)
    check(esc > 0 if marked else esc == 0.0,
          f"{label}: escape_rate {esc} {seen['escapes']}")
    counts = seen["launches"]
    if cfg.get("null"):
        check(not any(counts.values()),
              f"{label}: a kernel launched on the nulled device {counts}")
    elif name not in CONSTRAINT_ROWS:
        check(counts.get("claims", 0) > 0,
              f"{label}: the claims kernel never launched {counts}")
    st = res["stats"]["backend_stats"]
    if preempting:
        hp = seen["high"]
        check(hp["count"] == res["pods"] == hp["bound"],
              f"{label}: high-priority pods {hp}")
        check(d.get("preemption_attempts", 0) > 0,
              f"{label}: no preemption attempt")
        # every dry-run chunk of a wave is one launch (warmup's
        # all-inactive chunk is one more)
        check(counts.get("preempt", 0) >= st.get("preempt_chunks", 0) > 0,
              f"{label}: preempt launches {counts} for "
              f"{st.get('preempt_chunks', 0)} dry-run chunks")
        print(f"   {label}: {hp['bound']} of {hp['count']} high-priority "
              f"pods bound; {placed['deleted']} victims deleted; "
              f"preemption attempts {d['preemption_attempts']}; preemption "
              f"waves {st.get('preempt_waves', 0)} in "
              f"{st.get('preempt_chunks', 0)} dry-run chunks [{smi}]",
              flush=True)
    if cfg.get("overload") is True:
        inj = d.get("chaos_injected") or {}
        check(inj.get("slow", 0) > 0 and inj.get("all_escape", 0) > 0,
              f"{label}: chaos injected {inj}")
        check(not any(k.endswith(("/system", "/high"))
                      for k in d["overload"]["shed"]),
              f"{label}: shed protected pods {d['overload']}")
    if "storm" in d:
        inj = d["storm"]["injected"]
        check(all(inj.get(k, 0) > 0 for k in
                  ("node_add", "node_drain", "node_relabel")),
              f"{label}: storm {d['storm']}")
        check(not seen["rebinds"],
              f"{label}: pods bound twice {seen['rebinds'][:5]}")
    print(f"   {label}: {round(res['value'], 1)} pods/s; pod e2e "
          f"p50/p95/p99 {d.get('pod_e2e_p50_ms')} / "
          f"{d.get('pod_e2e_p95_ms')} / {d.get('pod_e2e_p99_ms')} ms; "
          f"placements from the store {placed}; batches {st['batches']}, "
          f"waves per batch {d.get('waves_per_batch', 'n/a (no device)')}, "
          f"full-variant batches {d.get('full_batches', 'n/a')}; escape "
          f"rate {esc} {seen['escapes']['by_reason']}; profiled-batch idle "
          f"share {seen.get('idle', 'n/a')}; launches {counts}; outside "
          f"the window: setup {d['setup_s']} s, node creation "
          f"{d['create_nodes_s']} s, flatten {d['flatten_before_window_s']} "
          f"s [{smi}]", flush=True)
    for key in ("overload", "chaos_injected", "storm"):
        if key in d:
            print(f"   {label}: {key} {d[key]}", flush=True)


def loop_phases(smi):
    """Phases 8-19: the bench configs through perf.bench.run_config on the
    card (store, informers, queue, Scheduler, TorchBatchBackend, binder),
    ROW_PASSES passes a config (bench.py runs its two_pass rows twice),
    each pass held to check_pass's invariants.  The kernels' counts are zeroed
    before each config and again at the end of each pass's `after` hook,
    so each pass reads its own main path's launches; the checks read the
    store, not the backend.  After each pass of a row without preemption
    (and after its launches were read), one more batch of the row's own
    pods runs under the profiler (idle share).  Phase 17 then reads the
    host ceiling at SchedulingBasic's depth (host_ceiling).  Returns
    {config: {kernel: the main path's launches over its passes}} and
    {config: row}."""
    from kubernetes_tpu_torch.api import meta
    from kubernetes_tpu_torch.client.clientset import PODS
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.perf import bench, load_workloads
    from kubernetes_tpu_torch.perf.scheduler_perf import is_measured

    def zero():
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
    launches, rows = {}, {}
    for num, name in LOOP_PHASES:
        with Phase(f"{num} {name} through the Scheduler"):
            gc.collect()
            torch.cuda.empty_cache()
            cfg = bench.CONFIGS[name]
            tpl = load_workloads()[cfg["workload"]]["workloadTemplate"]
            measured = next(op for op in tpl if is_measured(op, tpl))
            op = bench.profiled_op(tpl)
            preempting = name.startswith("Preemption")
            marked = "escapeEvery" in measured or cfg.get("overload") is True
            passes = []   # per pass: what `after` saw

            def after(cluster, name=name, cfg=cfg, op=op,
                      preempting=preempting, passes=passes):
                # this pass's main path: the counts were zeroed before it
                seen = {"pass": len(passes) + 1,
                        "launches": dict(kernels.LAUNCHES),
                        "escapes": pass_escapes(cluster)}
                if preempting:
                    pods, _ = cluster.store.list(PODS)
                    hp = [p for p in pods
                          if (p["spec"].get("priority") or 0) > 0]
                    seen["high"] = dict(count=len(hp), bound=sum(
                        1 for p in hp if meta.pod_node_name(p)))
                else:
                    if "storm" in name.lower():
                        ledger = bench.BindLedger(cluster.store, since_rv=0)
                        ledger.drain()
                        ledger.stop()
                        seen["rebinds"] = ledger.rebinds
                    seen["idle"] = profile_loop_batch(
                        cluster, cfg["batch"] if op is None
                        else min(cfg["batch"], PROFILED_PODS), name, smi,
                        op=op)
                    torch.cuda.synchronize()
                passes.append(seen)
                zero()       # the next pass starts from 0

            zero()
            row, results = bench.run_config(name, after=after,
                                            passes=ROW_PASSES)
            rows[name] = row
            print(json.dumps(row), flush=True)
            print(f"   {name} row measured on [{smi}]", flush=True)
            check(len(results) == len(passes) == ROW_PASSES,
                  f"{name}: {len(results)} passes, {len(passes)} read")
            for res, seen in zip(results, passes):
                check_pass(name, cfg, res, seen, smi, preempting, marked)
            check("error" not in row["detail"],
                  f"{name}: {row['detail'].get('error')}")
            launches[name] = {k: sum(p["launches"].get(k, 0) for p in passes)
                              for k in kernels.LAUNCHES}
            print(f"   {name}: kept {row['value']} pods/s, "
                  f"{row['detail'].get('second_pass', 'one pass')}; "
                  f"main-path launches over the passes {launches[name]} "
                  f"[{smi}]", flush=True)
            if cfg.get("null"):
                host_ceiling(rows, smi, zero)
    return launches, rows


def host_ceiling(rows, smi, zero, rounds=HOST_CEILING_ROUNDS):
    """Phase 17's second half: SchedulingHostNull and SchedulingBasic at
    the same depth (SchedulingBasic's 2) in turns, `rounds` times each, in
    this process: the card's share of the host ceiling per round and the
    spread of both.  Each run is held to every pod bound, no node over
    its caps and no escape; the nulled runs launch no kernel, the card's
    launch claims."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.perf import bench
    depth = bench.CONFIGS["SchedulingBasic"]["depth"]
    got = {"SchedulingHostNull": [], "SchedulingBasic": []}
    for r in range(rounds):
        for name in got:
            zero()
            res = bench.run_once(**{**bench.pass_args(name),
                                    "depth": depth})
            counts = dict(kernels.LAUNCHES)
            label = f"{name} at depth {depth}, round {r + 1}"
            check("error" not in res, f"{label}: {res.get('error')}")
            placed = res["detail"]["placements"]
            check(placed["bound"] == placed["pods"]
                  == res["stats"]["created_pods"]
                  and placed["nodes_over_capacity"] == 0,
                  f"{label}: placements {placed}")
            check(res["detail"].get("escape_rate", 0.0) == 0.0
                  and res["detail"]["schedule_attempts"]["error"] == 0,
                  f"{label}: escapes or ERROR statuses")
            check(not any(counts.values()) if name == "SchedulingHostNull"
                  else counts.get("claims", 0) > 0,
                  f"{label}: launches {counts}")
            got[name].append(res["value"])
            print(f"   {label}: {round(res['value'], 1)} pods/s, p99 "
                  f"{res['detail'].get('pod_e2e_p99_ms')} ms [{smi}]",
                  flush=True)
    null, card = got["SchedulingHostNull"], got["SchedulingBasic"]
    shares = [c / n for c, n in zip(card, null)]
    print(f"   host ceiling at depth {depth}, {rounds} rounds in turns: "
          f"SchedulingHostNull {min(null):.1f}-{max(null):.1f} pods/s, "
          f"SchedulingBasic {min(card):.1f}-{max(card):.1f} pods/s; the "
          f"card's share per round {[round(x, 4) for x in shares]}; the "
          f"depth-1 row {rows['SchedulingHostNull']['value']} pods/s beside "
          f"phase 8's {rows['SchedulingBasic']['value']} [{smi}]",
          flush=True)


def warm_start_phase(dev, smi, n_nodes=5000, n_pods=50_000, batch=16384):
    """Phase 20: checkpoint / warm start on the card at SchedulingBasic's
    shape.  One TorchBatchBackend on the card schedules the first batch;
    checkpoint_mirror writes its host state (KTPUCKPT v1) with the cluster's
    objects; a FRESH backend on the card warm-starts from the file, a
    FRESH cache is primed with the objects (a restarted informer's
    replay), warm_align adopts the rows, and the fresh backend schedules
    the remaining pods.  The first backend, never restarted, schedules the
    same remaining batches on its own cache: both result vectors must be
    equal pod for pod.  Every pod placed, no node over its CPU, memory or
    110-pod cap (from the returned names), the adopted rows reported."""
    import copy as _copy
    import tempfile
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    with Phase("20 warm start on the card"):
        sizes = [batch] * (n_pods // batch) + (
            [n_pods % batch] if n_pods % batch else [])
        cache = build_cluster(n_nodes, 20)
        nodes = [_copy.deepcopy(ni.node)
                 for ni in cache.update_snapshot(Snapshot()).list()]
        tagged = [make_batches(1, k, f"warm{b}")[0]
                  for b, k in enumerate(sizes)]

        def backend():
            b = TorchBatchBackend(caps_for_nodes(n_nodes), batch_size=batch,
                                  device=dev)
            b.warmup()
            return b

        def run(b, view_cache, infos):
            out = b.assign(infos, view_cache.flatten_view())
            torch.cuda.synchronize()
            assume(view_cache, infos, out)
            return out

        a = backend()
        a.prefetch(cache.flatten_view())
        first = run(a, cache, tagged[0])
        bound = [{**pi.pod, "spec": {**pi.pod["spec"], "nodeName": nm}}
                 for pi, (nm, _st) in zip(tagged[0], first) if nm]
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/warm.ckpt"
            t0 = time.monotonic()
            info = a.checkpoint_mirror(
                path, snapshot=cache.flatten_view(),
                resource_versions={"nodes": 1, "pods": 1},
                objects={"nodes": nodes, "pods": bound})
            write_s = time.monotonic() - t0
            b = backend()
            t0 = time.monotonic()
            warm = b.warm_start(path)
            load_s = time.monotonic() - t0
        fresh = Cache()
        fresh.add_nodes(warm["objects"]["nodes"])
        for p in warm["objects"]["pods"]:
            fresh.add_pod(p)
        t0 = time.monotonic()
        dropped = b.warm_align(fresh.flatten_view())
        align_s = time.monotonic() - t0
        adopted = b.stats.get("warm_adopted", 0)
        print(f"   checkpoint {info['bytes']} B, {info['nodes']} rows, "
              f"write {write_s:.3f} s; warm_start {load_s:.3f} s (lineage "
              f"{warm['lineage']}); warm_align {align_s:.3f} s: {adopted} "
              f"rows adopted, {dropped} dropped [{smi}]", flush=True)
        check(adopted == info["nodes"] == n_nodes and dropped == 0,
              f"warm start adopted {adopted} of {info['nodes']} rows")
        outs, ctrl, secs = [first], [first], []
        for infos in tagged[1:]:
            twin = [PodInfo(_copy.deepcopy(pi.pod)) for pi in infos]
            t0 = time.monotonic()
            outs.append(run(b, fresh, infos))
            secs.append(time.monotonic() - t0)
            ctrl.append(run(a, cache, twin))
        check(all([nm for nm, _ in o] == [nm for nm, _ in c]
                  for o, c in zip(outs, ctrl)),
              "the warm-started backend placed differently from the "
              "uninterrupted one")
        verify_placements(fresh, outs, n_pods, "warm start")
        print(f"   after the warm start: {len(secs)} batches in "
              f"{[round(x, 4) for x in secs]} s (the first includes the "
              f"device state's rebuild from the installed tensors), "
              f"{b.stats['full_refresh']} full refresh; equal to the "
              f"uninterrupted backend pod for pod [{smi}]", flush=True)
        return {"adopted": adopted, "bytes": info["bytes"]}


# phase 21: the batch pipeline's observability on the card (one round:
# two made the script too long for its 1,200 s limit)
OBS_ROUNDS = 1
OBS_GUARD_BATCHES = 10  # 20 made the script too long for its 1,200 s limit
# tests/test_tracing.py's pipeline spans, each with its parent's name
PIPELINE_PARENTS = {"queue.pop": "schedule_batch",
                    "snapshot.flatten": "schedule_batch",
                    "plugin.filter_masks": "schedule_batch",
                    "plugin.score": "schedule_batch",
                    "plugin.assign_solve": "schedule_batch",
                    "tpu.h2d": "plugin.assign_solve",
                    "tpu.d2h": "plugin.assign_solve",
                    "bind": "schedule_batch"}


def check_span_topology(provider):
    """The span count by name, and one bound batch's trace holding every
    pipeline span under its JAX parent."""
    spans = provider.snapshot()
    by_name = {}
    for sp in spans:
        by_name[sp.name] = by_name.get(sp.name, 0) + 1
    print(f"   spans by name {dict(sorted(by_name.items()))}", flush=True)
    ids = {sp.span_id: sp for sp in spans}
    for root in (sp for sp in spans if sp.name == "schedule_batch"):
        fam = [sp for sp in spans if sp.trace_id == root.trace_id]
        names = {sp.name for sp in fam}
        if "bind" not in names:
            continue
        check(set(PIPELINE_PARENTS) <= names,
              f"a bound batch's trace lacks "
              f"{sorted(set(PIPELINE_PARENTS) - names)}")
        for sp in fam:
            want = PIPELINE_PARENTS.get(sp.name)
            got = ids.get(sp.parent_span_id)
            check(want is None or (got is not None and got.name == want
                                   and got.trace_id == root.trace_id),
                  f"span {sp.name} under "
                  f"{None if got is None else got.name}, not {want}")
        attrs = {sp.name: sp.attributes for sp in fam}
        print(f"   one bound batch's trace: {len(fam)} spans, every "
              f"pipeline span under its JAX parent; assign_solve "
              f"{attrs['plugin.assign_solve']}, filter_masks "
              f"{attrs['plugin.filter_masks']}, h2d {attrs['tpu.h2d']}",
              flush=True)
        return
    check(False, "no traced batch reached bind")


def union_in_window(ring, window):
    """ms of the union of the ring's device-stage intervals inside the
    time.monotonic() window (start, end)."""
    from kubernetes_tpu_torch.component_base import timeline as cb_timeline
    w0, w1 = ring.wall(window[0]), ring.wall(window[1])
    pairs = [(max(r["t0_unix_s"], w0), min(r["t1_unix_s"], w1))
             for r in ring.intervals()
             if r["stage"] in cb_timeline.DEVICE_STAGES
             and r["t1_unix_s"] > w0 and r["t0_unix_s"] < w1]
    return cb_timeline.interval_union(pairs) * 1e3


def check_wave_bounds(ring, label, smi, tol_ms=1.0):
    """The upper side of the union check: every wave's device-step, read
    from CUDA events through the clock anchor, lies inside the host's
    window for that wave, from the launch (the end of its h2d) to the end
    of the scheduler's resolve, and each d2h inside its device-step, all
    within tol_ms.  A wrong anchor or a misplaced event falls outside."""
    by_wave = {}
    for r in ring.intervals():
        if r["wave"] is not None:
            by_wave.setdefault(r["wave"], {}).setdefault(
                r["stage"], []).append((r["t0_unix_s"], r["t1_unix_s"]))
    waves = 0
    # the least room, ms, between each device interval and its bounds
    # (negative: outside): after the launch, before the resolve's end
    after_launch = before_resolve = math.inf
    for wave, st in by_wave.items():
        if not {"h2d", "device-step", "resolve"} <= set(st):
            continue
        waves += 1
        launch = max(t1 for _t0, t1 in st["h2d"])
        done = max(t1 for _t0, t1 in st["resolve"])
        for d0, d1 in st["device-step"]:
            after_launch = min(after_launch, (d0 - launch) * 1e3)
            before_resolve = min(before_resolve, (done - d1) * 1e3)
            for c0, c1 in st.get("d2h", ()):
                check(c0 >= d0 - tol_ms / 1e3 and c1 <= d1 + tol_ms / 1e3,
                      f"{label}: wave {wave}'s d2h lies outside its "
                      f"device-step")
    print(f"   {label}: {waves} waves' device-step intervals (CUDA events) "
          f"inside the host's launch-to-resolve window: the least room "
          f"{after_launch:.4f} ms after the launch, {before_resolve:.4f} ms "
          f"before the resolve's end (tolerance {tol_ms} ms) [{smi}]",
          flush=True)
    check(waves > 0, f"{label}: no wave with h2d, device-step and resolve")
    check(after_launch >= -tol_ms and before_resolve >= -tol_ms,
          f"{label}: a device-step lies outside its wave's host window "
          f"({after_launch:.4f} ms after the launch, {before_resolve:.4f} "
          f"ms before the resolve's end)")


def observability_pass(armed, smi, label, inspect_pass=False):
    """One SchedulingBasic pass through perf.bench.run_once: with tracing
    at 1,000,000 per million, profiling.timeline and the census armed, or
    with all three off.  The armed pass that inspects also checks the span
    topology and, on one more batch under torch.profiler, that the
    timeline's device-stage union over that batch's window is no less
    than the profiler's busy time, less 1%."""
    from kubernetes_tpu_torch.component_base import timeline as cb_timeline
    from kubernetes_tpu_torch.component_base import tracing
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.perf import bench
    from kubernetes_tpu_torch.scheduler.config import ProfilingPolicy
    ring = cb_timeline.default_timeline
    provider = policy = None
    if armed:
        provider = tracing.TracerProvider(sampling_rate_per_million=1_000_000,
                                          max_spans=100_000)
        policy = ProfilingPolicy(timeline=True, census=True)
    seen = {}

    def after(cluster):
        seen["launches"] = dict(kernels.LAUNCHES)
        if not inspect_pass:
            return
        check_span_topology(provider)
        got = bench.profile_batch(cluster, 16384, "observability")
        torch.cuda.synchronize()
        check(got["done"], f"{label}: the profiled batch was not bound")
        union_ms = union_in_window(ring, got["window"])
        print(f"   {label} profiled batch: wall {got['wall_ms']:.3f} ms, "
              f"profiler busy {got['busy_ms']:.3f} ms (idle share "
              f"{got['idle_share']:.4f}); the timeline's device-stage union "
              f"over the same window {union_ms:.3f} ms (idle share "
              f"{1 - union_ms / got['wall_ms']:.4f}) [{smi}]", flush=True)
        check(union_ms >= got["busy_ms"] * 0.99,
              f"{label}: the timeline's device stages cover {union_ms:.3f} "
              f"ms, the profiler's kernels and copies {got['busy_ms']:.3f}")
        check_wave_bounds(ring, label, smi)

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    try:
        res = bench.run_once(**bench.pass_args("SchedulingBasic"),
                             tracing_provider=provider,
                             profiling_policy=policy, after=after)
    finally:
        ring.configure(enabled=False)
        ring.reset()
    check("error" not in res, f"{label}: {res.get('error')}")
    placed = res["detail"]["placements"]
    check(placed["bound"] == placed["pods"] == res["stats"]["created_pods"]
          and placed["nodes_over_capacity"] == 0,
          f"{label}: placements {placed}")
    check(seen["launches"].get("claims", 0) > 0,
          f"{label}: the claims kernel never launched ({seen['launches']})")
    stats = res["stats"]
    if armed:
        tl = stats.get("timeline") or {}
        check({"patch", "h2d", "device-step", "d2h"} <= set(tl.get(
            "stages", {})), f"{label}: timeline stages {tl.get('stages')}")
        census = stats.get("device_census") or {}
        check(set(census.get("torch", {})) == {"full", "plain"},
              f"{label}: census {sorted(census)}")
        if inspect_pass:
            print(f"   {label}: timeline stages {tl['stages']}, device idle "
                  f"share {tl['device_idle_share']}, overlap "
                  f"{tl['overlap']}, {tl['pods_decomposed']} pods "
                  f"in the ring; per-pod segments (p50/p95/p99 ms over "
                  f"{next(iter(tl['segments'].values()))['count']} pods) "
                  + ", ".join(f"{k} {v['p50_ms']}/{v['p95_ms']}/"
                              f"{v['p99_ms']}" for k, v in
                              tl["segments"].items()) + f" [{smi}]",
                  flush=True)
    else:
        check("timeline" not in stats and not ring.intervals(),
              f"{label}: the off pass recorded a timeline")
    print(f"   {label}: {round(res['value'], 1)} pods/s, p99 "
          f"{res['detail'].get('pod_e2e_p99_ms')} ms, claims launches "
          f"{seen['launches'].get('claims', 0)} [{smi}]", flush=True)
    return res["value"]


def census_at_100k(dev, smi, n_nodes=100_000, batch=16384):
    """The census of both variants on a backend at Scheduling100k's caps
    (110,080 rows; plain at 16,384 pods, full at its full_cap) after one
    batch of SchedulingBasic pods on 100,000 nodes: it must leave
    LAUNCHES, the resident state and _gen as it found them, and the
    plain variant's claims launches are its waves, each counted at the
    bytes of the count beside the kernel (PERF.md's bound's numerator)."""
    from kubernetes_tpu_torch.models import carry
    from kubernetes_tpu_torch.ops import kernels
    cache = build_cluster(n_nodes, 21)
    backend, _outs, _secs, _waves = drive(
        cache, make_batches(1, batch, "census"), dev, "census 100k", batch,
        claims_noise="sin")
    torch.cuda.synchronize()
    state0, _ = carry.state_to_numpy(backend._state)
    gen0, launches0 = backend._gen, dict(kernels.LAUNCHES)
    t0 = time.monotonic()
    census = backend.device_census()
    secs = time.monotonic() - t0
    state1, _ = carry.state_to_numpy(backend._state)
    check(kernels.LAUNCHES == launches0 and backend._gen == gen0
          and all(np.array_equal(state0[k], state1[k]) for k in state0),
          "census 100k: the census moved the backend's counts or state")
    P, N, R = batch, backend.caps.n_cap, backend.caps.r
    per_call = kernels.claims_bytes(P, N, R)
    call_ms, call_by = kernels.bound(per_call)
    for variant, rec in census.items():
        ks = "; ".join(
            f"{name}: {k['launches']} launches, {k['device_ms']:.4f} ms on "
            f"the card, {k['bytes']} B, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})" for name, k in rec["kernels"].items())
        print(f"   census 100k {variant} ({rec['batch']['pods']} pods of "
              f"{rec['batch']['req']}): {rec['waves']} waves, device "
              f"{rec['device_ms']:.3f} ms, flops {rec['cost']['flops']:.6g}, "
              f"bytes accessed {rec['cost']['bytes_accessed']:.6g}; "
              f"{ks or 'no hand kernel'} [{smi}]", flush=True)
    k = census["plain"]["kernels"].get("claims")
    check(k is not None and k["launches"] == census["plain"]["waves"] >= 1
          and k["bytes"] == k["launches"] * per_call,
          f"census 100k: claims {k}")
    print(f"   census 100k: {secs:.3f} s for both variants; the claims "
          f"kernel's bytes a call by the count beside it (the census's "
          f"bytes and the bound's numerator) {per_call} B, bound "
          f"{call_ms:.4f} ms ({call_by}), PERF.md's wave bound 0.5413 ms "
          f"[{smi}]", flush=True)
    check((P, N) != (16384, 110_080) or round(call_ms, 4) == 0.5413,
          f"census 100k: the claims bound {call_ms:.4f} ms moved")


def sync_and_build_census(dev, smi, batches=OBS_GUARD_BATCHES, n_nodes=5000,
                          batch=16384):
    """Steady plain batches at SchedulingBasic's shape (5,000 nodes,
    16,384 pods a batch) under SyncGuard and BuildCounter, after warmup
    and two batches: every implicit sync at a `# sync-point:` site, the
    syncs per batch and per device wave, and nothing built or loaded."""
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.testing.sanitizers import (
        BuildCounter, SyncGuard,
    )
    cache = build_cluster(n_nodes, 22)
    backend = TorchBatchBackend(caps_for_nodes(n_nodes), batch_size=batch,
                                device=dev)
    backend.warmup()
    view = cache.flatten_view()
    todo = make_batches(batches + 2, batch, "guard")
    for infos in todo[:2]:
        assume(cache, infos, backend.assign(infos, view))
    w0 = backend.stats["waves"]
    with SyncGuard("warn") as guard, BuildCounter() as built:
        for infos in todo[2:]:
            assume(cache, infos, backend.assign(infos, view))
    guard_report(guard, built, "steady plain batches",
                 [(batches, "batch", "batches"),
                  (backend.stats["waves"] - w0, "device wave",
                   "device waves")], smi)


def guard_report(guard, built, label, counts, smi):
    """Print one SyncGuard / BuildCounter reading with the syncs per unit
    of `counts` ((n, unit, units), e.g. (20, "batch", "batches")), and
    fail on an implicit sync without a # sync-point: comment or on a
    build or load."""
    root = Path(__file__).resolve().parent
    sites = {("outside the package" if s is None else
              f"{Path(s[0]).relative_to(root)}:{s[1]}"): n
             for s, n in sorted(guard.sites.items(),
                                key=lambda kv: str(kv[0]))}
    over = ", ".join(f"{n} {unit if n == 1 else units}"
                     for n, unit, units in counts)
    per = ", ".join(f"{guard.syncs / max(n, 1):.2f} a {unit}"
                    for n, unit, _units in counts)
    print(f"   SyncGuard over {label} ({over}): {guard.syncs} implicit "
          f"syncs (a lower bound), {per}; sites {sites}; BuildCounter "
          f"builds {built.builds} loads {built.loads} [{smi}]", flush=True)
    check(not guard.unannotated(),
          f"{label}: implicit syncs without a # sync-point: comment at "
          f"{guard.unannotated()}")
    check(built.count == 0, f"{label}: built {built.builds} and loaded "
                            f"{built.loads}")


def sync_census_other_paths(dev, smi, n_nodes=5000, batch=1024, batches=3,
                            n_pre=1024):
    """SyncGuard and BuildCounter over the paths the plain census leaves
    out: `batches` constraint batches of phase (a)'s mix (the full
    variant) on n_nodes zoned nodes after one batch, and one wave of n_pre
    preemptors (preempt_batch, the dry-run kernel) on n_nodes nodes of
    PreemptionBasic's shape after a wave of a quarter as many."""
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.scheduler.cache import Snapshot
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    from kubernetes_tpu_torch.testing import make_pod
    from kubernetes_tpu_torch.testing.sanitizers import (
        BuildCounter, SyncGuard,
    )
    cache = build_zoned_cluster(n_nodes, 23, disk_labels=True)
    backend = TorchBatchBackend(caps_for_nodes(n_nodes), batch_size=batch,
                                device=dev)
    backend.warmup()
    view = cache.flatten_view()
    todo = [[PodInfo(mixed_pod(f"sg{b}-{i}", i)) for i in range(batch)]
            for b in range(batches + 1)]
    assume(cache, todo[0], backend.assign(todo[0], view))
    w0, f0 = backend.stats["waves"], backend.stats.get("plain", 0)
    with SyncGuard("warn") as guard, BuildCounter() as built:
        for infos in todo[1:]:
            assume(cache, infos, backend.assign(infos, view))
    check(backend.stats.get("plain", 0) == f0,
          "constraint batches took the plain variant")
    guard_report(guard, built, "the full variant",
                 [(batches, "constraint batch", "constraint batches"),
                  (backend.stats["waves"] - w0, "device wave",
                   "device waves")], smi)
    del backend, cache, view, todo
    gc.collect()
    torch.cuda.empty_cache()

    cache = build_preempt_cluster(n_nodes, 4, 24)
    snap = cache.update_snapshot(Snapshot())
    backend = TorchBatchBackend(caps=caps_for_nodes(n_nodes), batch_size=batch,
                                device=dev)
    backend.prefetch(cache.flatten_view())
    backend.warmup()
    pre = [PodInfo(make_pod(f"sg-pre-{j}").priority(10)
                   .req(cpu="3000m", mem="500Mi").build())
           for j in range(n_pre)]
    node_ord_of = {ni.name: i for i, ni in enumerate(snap.list())}
    backend.preempt_batch(pre[:n_pre // 4], node_ord_of)
    chunks = -(-n_pre // backend.PREEMPT_P_CAP)
    with SyncGuard("warn") as guard, BuildCounter() as built:
        results, esc = backend.preempt_batch(pre, node_ord_of)
    won = sum(r is not None for r in results)
    check(not esc and won == min(n_pre, n_nodes),
          f"guarded preemption wave: escapes {esc}, {won} of {n_pre} won")
    guard_report(guard, built, "a preemption wave",
                 [(chunks, "dry-run chunk", "dry-run chunks")], smi)


def observability_phase(dev, smi, rounds=OBS_ROUNDS):
    """Phase 21: the batch pipeline's observability on the card."""
    with Phase("21 observability"):
        gc.collect()
        torch.cuda.empty_cache()
        ratios = []
        for r in range(rounds):
            order = (True, False) if r % 2 == 0 else (False, True)
            got = {armed: observability_pass(
                armed, smi, f"SchedulingBasic {'armed' if armed else 'off'}"
                f", round {r + 1}", inspect_pass=armed and r == 0)
                for armed in order}
            ratios.append(got[True] / got[False])
        print(f"   armed / off pods/s per round "
              f"{[round(x, 4) for x in ratios]} (in turns; no gate: the "
              f"host spreads more than the instrumentation costs) [{smi}]",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        census_at_100k(dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
        sync_and_build_census(dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
        sync_census_other_paths(dev, smi)


# phases 22-25: the device worker seam (ops/remote.py) on the card
SEAM_LOOP_ROWS = ("SchedulingBasic", "Scheduling100k")
WORKER_START_S = 300.0


class WorkerProcess:
    """`python3 -m kubernetes_tpu_torch.cmd.tpu_worker --port 0 --device
    cuda` as a subprocess of this script: its URL is read from the line
    it prints once it serves; its output is drained by a thread (the last
    lines are printed when a check fails); stop() sends SIGTERM and
    reaps it (SIGKILL after 30 s)."""

    def __init__(self, device="cuda"):
        import threading
        self.lines = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.cmd.tpu_worker",
             "--port", "0", "--device", device],
            cwd=str(Path(__file__).resolve().parent),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.url = None
        ready = threading.Event()

        def drain():
            for line in self.proc.stdout:
                self.lines = (self.lines + [line.rstrip()])[-200:]
                if line.startswith("tpu-worker listening on "):
                    self.url = line.split()[-1]
                    ready.set()
            ready.set()
        threading.Thread(target=drain, daemon=True).start()
        ready.wait(WORKER_START_S)
        if self.url is None:
            self.stop()
            raise SystemExit("CHECK FAILED: the worker process printed no "
                             "URL: " + "\n".join(self.lines[-20:]))

    def get(self, path):
        import urllib.request
        with urllib.request.urlopen(self.url + path, timeout=120) as r:
            return json.loads(r.read())

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def row_over_worker(name, worker, smi, rows_inproc):
    """One bench config through the Scheduler with the batch backend
    behind the worker process (bench.run_config(remote_seam=URL)), every
    pass held to check_pass's invariants, the launches read from the
    worker (its counts are zeroed before each pass and read, then zeroed,
    in the pass's `after` hook); pods/s printed beside this run's
    in-process row.  Returns the main path's launches over the passes."""
    from kubernetes_tpu_torch.api import meta
    from kubernetes_tpu_torch.client.clientset import PODS
    from kubernetes_tpu_torch.perf import bench
    cfg = bench.CONFIGS[name]
    preempting = name.startswith("Preemption")
    passes = []

    def after(cluster):
        seen = {"pass": len(passes) + 1,
                "launches": worker.get("/debug/kernels?reset=1")["launches"],
                "escapes": pass_escapes(cluster)}
        if preempting:
            pods, _ = cluster.store.list(PODS)
            hp = [p for p in pods if (p["spec"].get("priority") or 0) > 0]
            seen["high"] = dict(count=len(hp), bound=sum(
                1 for p in hp if meta.pod_node_name(p)))
        passes.append(seen)

    gc.collect()
    torch.cuda.empty_cache()
    worker.get("/debug/kernels?reset=1")
    try:
        row, results = bench.run_config(name, remote_seam=worker.url,
                                        after=after, passes=ROW_PASSES)
    except BaseException:
        print("\n".join(worker.lines[-20:]), flush=True)
        raise
    print(json.dumps(row), flush=True)
    check(len(results) == len(passes) == ROW_PASSES,
          f"{name} over the worker: {len(results)} passes, "
          f"{len(passes)} read")
    for res, seen in zip(results, passes):
        check_pass(f"{name} over the worker", cfg, res, seen, smi,
                   preempting, False)
    check("error" not in row["detail"],
          f"{name} over the worker: {row['detail'].get('error')}")
    launches = {k: sum(p["launches"].get(k, 0) for p in passes)
                for k in passes[0]["launches"]}
    inproc = rows_inproc.get(name)
    print(f"   {name} through the Scheduler over the worker process: "
          f"{row['value']} pods/s (in process, this run: "
          f"{inproc['value'] if inproc else 'not run'} pods/s); launches in "
          f"the worker over the passes {launches} [{smi}]", flush=True)
    return launches


def census_over_worker(worker, dev, smi, n_nodes=5000, batch=4096):
    """Phase 22's census: a RemoteTorchBatchBackend on the worker process
    and a TorchBatchBackend in this process, both on the card, take the
    same batches (4,096 plain pods, then 1,024 of phase (a)'s mix) on the
    same zoned cluster; device_census() through the worker (/census)
    must equal the in-process census in every field but device_ms."""
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.ops.remote import RemoteTorchBatchBackend
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.scheduler.types import PodInfo

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k != "device_ms"}
        return x

    def device_ms(c):
        return {v: (round(c[v]["device_ms"], 4),
                    {k: round(kk["device_ms"], 4)
                     for k, kk in c[v]["kernels"].items()}) for v in c}

    caps = caps_for_nodes(n_nodes)
    # each backend on its own copy of the cluster (a flatten view tracks
    # what its one consumer has synced)
    views = [build_zoned_cluster(n_nodes, 22, disk_labels=True)
             .flatten_view() for _ in range(2)]
    batches = [make_batches(1, batch, "c22")[0],
               [PodInfo(mixed_pod(f"c22m-{i}", i)) for i in range(1024)]]
    remote = RemoteTorchBatchBackend(worker.url, caps, batch_size=batch)
    local = TorchBatchBackend(caps, batch_size=batch, device=dev)
    try:
        for infos in batches:
            outs = [[n for n, _st in b.assign(infos, v)]
                    for b, v in zip((remote, local), views)]
            check(outs[0] == outs[1] and all(outs[0]),
                  "census phase: the worker and the in-process backend "
                  "placed differently, or left pods unplaced")
        t0 = time.monotonic()
        got = remote.device_census()
        t1 = time.monotonic()
        want = local.device_census()
        t2 = time.monotonic()
    finally:
        remote.close()
    check(strip(got) == strip(want),
          f"census over the worker differs from the in-process census: "
          f"{json.dumps(strip(got))[:400]} vs {json.dumps(strip(want))[:400]}")
    print(f"   device_census() over the worker (/census, {t1 - t0:.3f} s) "
          f"equals the in-process census ({t2 - t1:.3f} s) in every field "
          f"but device_ms; waves {[got[v]['waves'] for v in got]}; "
          f"device_ms worker {device_ms(got)} in process {device_ms(want)} "
          f"[{smi}]", flush=True)


def seam_phases(dev, smi, rows_inproc):
    """Phases 22-25.  22: a worker in a separate process on the card
    (cmd.tpu_worker), SchedulingBasic and Scheduling100k through the
    Scheduler over HTTP to it, then its /debug/timeline's device-step
    intervals.  23: the RemoteSeamGrpc row (bench.run_seam: 5,000 nodes,
    six rounds of 4,096) with an in-process worker, the remote and
    in-process placements equal.  24: RemoteSeamFaulty: seeded faults, a
    kill and resync, an outage that opens the breaker and fails back.
    25: PreemptionBasic (one pass) over the worker process, /preempt
    served there.  23-24 run gRPC where grpc imports, else HTTP, and say
    so.  Returns the launches of 22's Scheduling100k and 25 (the worker's
    counts)."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.remote import grpc_available
    from kubernetes_tpu_torch.perf import bench
    launches = {}
    worker = WorkerProcess()
    try:
        with Phase("22 SchedulingBasic and Scheduling100k over a worker "
                   "process"):
            print(f"   worker process {worker.proc.pid} at {worker.url}",
                  flush=True)
            for name in SEAM_LOOP_ROWS:
                launches[name] = row_over_worker(name, worker, smi,
                                                 rows_inproc)
                check(launches[name].get("claims", 0) > 0,
                      f"{name} over the worker: no claims launch")
            tl = worker.get("/debug/timeline")
            steps = [r for r in tl.get("interval_rows", [])
                     if r.get("stage") == "device-step"]
            check(bool(steps) and all(r["t1_unix_s"] > r["t0_unix_s"]
                                      for r in steps),
                  f"the worker's timeline holds no device-step interval: "
                  f"{str(tl)[:300]}")
            ms = sorted((r["t1_unix_s"] - r["t0_unix_s"]) * 1e3
                        for r in steps)
            print(f"   worker /debug/timeline: {len(steps)} device-step "
                  f"intervals, ms p50 {statistics.median(ms):.3f} max "
                  f"{ms[-1]:.3f} [{smi}]", flush=True)
            census_over_worker(worker, dev, smi)
        kind = "grpc" if grpc_available() else "http"
        if kind == "http":
            print("   gRPC seam not run: the grpc package does not import "
                  "here; phases 23-24 run the HTTP seam (DeviceWorker)",
                  flush=True)
        with Phase(f"23 RemoteSeamGrpc row over {kind}"):
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            res = bench.run_seam(kind, device=dev)
            print(f"   {res['seam']}: {res['nodes']} nodes, {res['rounds']} "
                  f"rounds of {res['batch']}: inproc_pods_per_s "
                  f"{res['inproc_pods_per_s']} remote_pods_per_s "
                  f"{res['remote_pods_per_s']} seam_cost_ratio "
                  f"{res['seam_cost_ratio']}; placed {res['placed']}; "
                  f"launches {dict(kernels.LAUNCHES)} [{smi}]", flush=True)
            check(min(res["placed"]) == res["batch"],
                  f"seam row: placed {res['placed']}")
            check(res["assignments_equal"],
                  "seam row: the remote and in-process placements differ")
            check(kernels.LAUNCHES["claims"] > 0, "seam row: no claims "
                  "launch")
        with Phase(f"24 RemoteSeamFaulty row over {kind}"):
            res = bench.run_seam(kind, faulty=True, device=dev)
            fo = res["failover"]
            print(f"   {res['seam']}: inproc_pods_per_s "
                  f"{res['inproc_pods_per_s']} remote_pods_per_s "
                  f"{res['remote_pods_per_s']} seam_cost_ratio "
                  f"{res['seam_cost_ratio']}; placed {res['placed']}; "
                  f"injected {res['injected']}; served by "
                  f"{res['served_by']}; ladder {fo}; breakers "
                  f"{res['breakers']}; requeues {res['bench_requeues']} "
                  f"[{smi}]", flush=True)
            check(min(res["placed"]) == res["batch"],
                  f"faulty row: placed {res['placed']}")
            check(res["injected"]["kill"] == 1 and fo["remote_resyncs"] >= 1,
                  f"faulty row: kill {res['injected']}, ladder {fo}")
            check(res["remote_rounds_equal"],
                  "faulty row: the remote rung's rounds after the resync "
                  "differ from an uninterrupted run's")
            check(fo["failovers"] >= 1 and fo["recloses"] >= 1
                  and res["breakers"]["remote"] == 0.0,
                  f"faulty row: breaker {res['breakers']}, ladder {fo}")
        with Phase("25 PreemptionBasic over the worker process"):
            launches["PreemptionBasic"] = row_over_worker(
                "PreemptionBasic", worker, smi, rows_inproc)
            served = worker.get("/debug/kernels")["served"]
            print(f"   the worker served {served} [{smi}]", flush=True)
            check(served.get("/preempt", 0) > 0
                  and launches["PreemptionBasic"].get("preempt", 0) > 0,
                  f"PreemptionBasic over the worker: /preempt served "
                  f"{served}, launches {launches['PreemptionBasic']}")
    finally:
        worker.stop()
    return launches


# -- phases 26-27: the multi-device sharded path (parallel/) on the card ---

SHARD_BATCHES = 2          # phase 26: batches of 16,384 at 100k nodes
SHARD_GUARD_BATCHES = 2    # phase 26: batches under SyncGuard
SHARD_SPLIT = 4            # the one-card mesh: shards of cuda:0


def shard_offsets_phase(kernels, dev, smi, n_cap=110_080, P=16384,
                        shards=SHARD_SPLIT):
    """The claims kernel at every shard's node offset under `shards`
    shards of n_cap rows, at one shard's shape (P pods x n_cap / shards
    nodes, murmur): held bit for bit against its plain version at the same
    offset, each launch timed between CUDA events.  Returns (max |best|
    error, {offset: ms})."""
    n_loc = n_cap // shards
    args = random_claims_case(P, n_loc, 26, dev)
    errs, times = [], {}
    for s in range(shards):
        off = s * n_loc
        got, best = kernels.claims(*args, noise="murmur", node_offset=off)
        want, want_best = kernels.claims_reference(*args, noise="murmur",
                                                   node_offset=off)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, want)) and bool(torch.equal(best,
                                                                want_best)),
              f"shard {s} (offset {off}): claims not bit-identical")
        errs.append(float((best - want_best).abs().max()))
        times[off] = time_cuda(lambda off=off: kernels.claims(
            *args, noise="murmur", node_offset=off), 10)
        print(f"   shard {s}/{shards} {P}x{n_loc} murmur at node_offset "
              f"{off}: bit-identical to the plain version; "
              f"{times[off]:.4f} ms/launch (median of 10) [{smi}]",
              flush=True)
    base, _ = kernels.claims(*args, noise="murmur")
    shifted, _ = kernels.claims(*args, noise="murmur", node_offset=n_loc)
    print(f"   the offset moves the noise: {int((base != shifted).sum())} "
          f"of {P} claims differ between offsets 0 and {n_loc}", flush=True)
    return max(errs), times


def sharded_plain_phase(kernels, dev, smi, n_nodes=100_000, batch=16384,
                        n_batches=SHARD_BATCHES):
    """ShardedTorchBatchBackend.assign on make_mesh() (every visible card)
    and on SHARD_SPLIT shards of cuda:0, and TorchBatchBackend at murmur
    noise, each on the same batches of plain pods on phase 6's cluster:
    per batch all three see the same cache and must place every pod
    alike, then the placements are assumed.  The claims count is zeroed
    just before each sharded assign and read just after (the single-device
    comparison's launches are not counted).  Then the census's collective
    bytes on the split mesh and SyncGuard over SHARD_GUARD_BATCHES more
    batches on it.  Returns the sharded assigns' claims launches."""
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.parallel.backend import ShardedTorchBatchBackend
    from kubernetes_tpu_torch.parallel.mesh import make_mesh
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.testing.sanitizers import (
        BuildCounter, SyncGuard,
    )
    # a cache feeds one backend (its flatten view drains the node delta):
    # each backend gets its own copy of the cluster
    backends, caches = {}, {}
    for label, mesh in (("mesh", make_mesh()),
                        (f"{SHARD_SPLIT} shards of cuda:0",
                         make_mesh("cuda:0", shards=SHARD_SPLIT)),
                        ("single device, murmur", None)):
        t0 = time.monotonic()
        caches[label] = build_cluster(n_nodes, 1)
        if mesh is None:
            b = TorchBatchBackend(caps_for_nodes(n_nodes), batch_size=batch,
                                  device=dev, claims_noise="murmur")
        else:
            b = ShardedTorchBatchBackend(caps_for_nodes(n_nodes),
                                         batch_size=batch, mesh=mesh)
        b.prefetch(caches[label].flatten_view())
        b.warmup()
        print(f"   {label} {mesh or dev}: n_cap {b.caps.n_cap}, "
              f"{b.caps.n_cap // (mesh.size if mesh else 1)} rows a "
              f"shard; setup {time.monotonic() - t0:.3f} s", flush=True)
        backends[label] = b
    secs = {k: [] for k in backends}
    launched = {k: 0 for k in backends if k != "single device, murmur"}
    for bi, infos in enumerate(make_batches(n_batches, batch, "shard")):
        outs = {}
        for label, b in backends.items():
            sharded = label in launched
            if sharded:
                kernels.LAUNCHES["claims"] = 0
            w0 = b.stats["waves"]
            t0 = time.monotonic()
            outs[label] = b.assign(infos, caches[label].flatten_view())
            torch.cuda.synchronize()
            secs[label].append(time.monotonic() - t0)
            if sharded:
                n = kernels.LAUNCHES["claims"]
                waves = b.stats["waves"] - w0
                check(n == waves * b.mesh.size,
                      f"{label}: {n} claims launches for {waves} waves on "
                      f"{b.mesh.size} shards")
                launched[label] += n
        want = outcome_names(outs["single device, murmur"])
        for label, out in outs.items():
            check(outcome_names(out) == want,
                  f"batch {bi}: {label} places otherwise than the single "
                  f"device at murmur")
        for label, out in outs.items():
            assume(caches[label], infos, out)
        print(f"   batch {bi}: {len(want)} pods placed alike by "
              f"{len(outs)} backends", flush=True)
    for label, s in secs.items():
        print(f"   {label}: {n_batches * batch / sum(s):.1f} pods/s over "
              f"{n_batches} batches, {(n_batches - 1) * batch / sum(s[1:]):.1f}"
              f" over the last {n_batches - 1} (batch wall s "
              f"{[round(x, 4) for x in s]}); waves "
              f"{backends[label].stats['waves']} [{smi}]", flush=True)
    split = backends[f"{SHARD_SPLIT} shards of cuda:0"]
    shard_ms = main_path_shard_launches(kernels, split, dev, smi, batch)
    t0 = time.monotonic()
    census = split.device_census()
    for variant, rec in census.items():
        per_wave = {r["op"]: r["bytes"] * r["count"]
                    for r in rec["collectives"].values() if r["per_wave"]}
        per_call = {r["op"]: r["bytes"] * r["count"]
                    for r in rec["collectives"].values()
                    if not r["per_wave"]}
        print(f"   census on {SHARD_SPLIT} shards at 100k, {variant} "
              f"({rec['batch']['pods']} pods, {rec['waves']} waves): "
              f"collective bytes a wave by kind {per_wave} (total "
              f"{rec['per_wave_bytes']:.1f}), a call {per_call}; device "
              f"{rec['device_ms']:.3f} ms (counts of a mesh of "
              f"{SHARD_SPLIT} devices, not a transfer: the shards share "
              f"one card) [{smi}]", flush=True)
    check(census["plain"]["per_wave_bytes"] > 0,
          "census: the plain variant counted no collective")
    print(f"   census {time.monotonic() - t0:.3f} s", flush=True)
    cache = caches[f"{SHARD_SPLIT} shards of cuda:0"]
    view = cache.flatten_view()
    for label in ("single device, murmur", "mesh"):
        del backends[label], caches[label]
    w0 = split.stats["waves"]
    guard_infos = make_batches(SHARD_GUARD_BATCHES, batch, "shard-guard")
    with SyncGuard("warn") as guard, BuildCounter() as built:
        for infos in guard_infos:
            assume(cache, infos, split.assign(infos, view))
    guard_report(guard, built, f"sharded plain batches on {SHARD_SPLIT} "
                 f"shards", [(SHARD_GUARD_BATCHES, "batch", "batches"),
                             (split.stats["waves"] - w0, "sharded wave",
                              "sharded waves")], smi)
    return sum(launched.values()), shard_ms


def main_path_shard_launches(kernels, backend, dev, smi, batch):
    """Each shard's claims launch of a wave on the main path's inputs: a
    batch of `batch` SchedulingBasic pods (every node statically eligible)
    on the state the batches left on `backend`'s shards, at the shard's
    node offset: held bit for bit against the plain version, the kernel
    timed between CUDA events beside the plain version (shard 0).
    Returns {offset: ms}."""
    from kubernetes_tpu_torch.ops.kernels import prepare_static
    pods = backend.encoder.encode(make_batches(1, batch, "probe")[0])
    req = torch.from_numpy(pods.req).to(dev)
    req_nz = torch.from_numpy(pods.req_nz).to(dev)
    active = torch.ones(batch, dtype=torch.bool, device=dev)
    out = {}
    for s in range(backend.mesh.size):
        st = {k: backend._state[k][s] for k in ("used", "used_nz", "npods")}
        node = {k: backend._static_node[k][s]
                for k in ("alloc", "maxpods", "valid")}
        n_loc = node["alloc"].shape[0]
        smask = node["valid"][:, None].expand(n_loc, batch)
        args = (prepare_static(req, req_nz, node["alloc"], node["maxpods"],
                               smask), active, st["used"], st["used_nz"],
                st["npods"])
        off = backend.comm.my_offset(s)
        got = kernels.claims(*args, noise="murmur", node_offset=off)
        want = kernels.claims_reference(*args, noise="murmur",
                                        node_offset=off)
        torch.cuda.synchronize()
        check(all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
              f"shard {s} on the main path's inputs: not bit-identical")
        out[off] = time_cuda(lambda: kernels.claims(
            *args, noise="murmur", node_offset=off), 10)
        plain = ""
        if s == 0:
            plain_ms = time_cuda(lambda: kernels.claims_reference(
                *args, noise="murmur", node_offset=off), 3, warmup=1)
            plain = f"; plain version {plain_ms:.4f} ms"
        print(f"   shard {s} main-path launch {batch}x{n_loc} murmur at "
              f"node_offset {off}: bit-identical; {out[off]:.4f} "
              f"ms/launch (median of 10){plain} [{smi}]", flush=True)
    return out


def outcome_names(out):
    return [name for name, _st in out]


def sharded_full_phase(dev, smi, n_nodes=5000, batch=1024):
    """One constraint batch of phase (a)'s mix on n_nodes zoned nodes
    (zones round-robin, so every zone spans every shard) through the
    sharded backend on SHARD_SPLIT shards of cuda:0 and through
    TorchBatchBackend's full variant at the batch size: the same
    placements.  The sharded full step's wave ceiling is the JAX core's
    128, so the batch must finish below it to compare."""
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.parallel.backend import ShardedTorchBatchBackend
    from kubernetes_tpu_torch.parallel.mesh import make_mesh
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    infos = [PodInfo(mixed_pod(f"s26-{i}", i)) for i in range(batch)]
    got = {}
    for label, b in (
            ("sharded", ShardedTorchBatchBackend(
                caps_for_nodes(n_nodes), batch_size=batch,
                mesh=make_mesh("cuda:0", shards=SHARD_SPLIT))),
            ("single", TorchBatchBackend(
                caps_for_nodes(n_nodes), batch_size=batch, device=dev,
                claims_noise="murmur", full_batch_cap=batch))):
        view = build_zoned_cluster(n_nodes, 3, disk_labels=True) \
            .flatten_view()
        b.prefetch(view)
        b.warmup()
        t0 = time.monotonic()
        got[label] = b.assign(infos, view)
        torch.cuda.synchronize()
        waves = b.stats["waves"]
        print(f"   {label}: {time.monotonic() - t0:.3f} s, {waves} waves, "
              f"placed {sum(1 for n, _ in got[label] if n)} of {batch} "
              f"[{smi}]", flush=True)
        check(waves < 128, f"{label}: {waves} waves reach the sharded "
                           f"step's ceiling; the comparison does not hold")
    check([(n, st and st.code) for n, st in got["sharded"]]
          == [(n, st and st.code) for n, st in got["single"]],
          "the sharded full variant places otherwise than the single "
          "device's")
    print(f"   the constraint batch on {SHARD_SPLIT} shards equals the "
          f"single device's full variant, pod for pod", flush=True)


def sharded_phases(dev, smi, rows):
    """Phases 26-27: the multi-device sharded path (parallel/mesh.py,
    parallel/backend.py).  26: the claims kernel at every shard's node
    offset, the sharded backend on the machine's mesh and on four shards
    of one card against the single device at murmur on phase 6's cluster,
    the census's collective bytes, SyncGuard a sharded wave, and one
    constraint batch on four shards against the single device's full
    variant.  27: Scheduling100k through the Scheduler with backend:
    sharded on make_mesh() at bench.py's headline configuration (census
    and timeline armed) held to phase 9's checks, the claims kernel
    launched once a shard per plain wave; then TopologySpreading on four
    shards of one card held to phase 15's.  Returns (the claims launches
    of 26's sharded assigns and 27's passes, max |best| error of the
    offsets, {"random" | "main path": {offset: ms}})."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.parallel.mesh import make_mesh
    from kubernetes_tpu_torch.perf import bench

    def zero():
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
    t0 = time.monotonic()
    with Phase("26 the sharded seam, 100k nodes"):
        gc.collect()
        torch.cuda.empty_cache()
        err, offset_ms = shard_offsets_phase(kernels, dev, smi)
        launches, shard_ms = sharded_plain_phase(kernels, dev, smi)
        gc.collect()
        torch.cuda.empty_cache()
        sharded_full_phase(dev, smi)
    for num, name, mesh in (
            ("27", "Scheduling100k", make_mesh()),
            ("27", "TopologySpreading",
             make_mesh("cuda:0", shards=SHARD_SPLIT))):
        with Phase(f"{num} {name} through the Scheduler, backend: sharded "
                   f"on {mesh}"):
            gc.collect()
            torch.cuda.empty_cache()
            cfg = bench.CONFIGS[name]
            passes = []

            def after(cluster, passes=passes):
                backend = cluster.scheduler.profiles[
                    "default-scheduler"].batch_backend
                passes.append({"pass": len(passes) + 1,
                               "launches": dict(kernels.LAUNCHES),
                               "escapes": pass_escapes(cluster),
                               "stats": dict(backend.stats)})
                zero()
            zero()
            row, results = bench.run_config(name, after=after,
                                            backend_kind="sharded",
                                            mesh=mesh, passes=ROW_PASSES)
            print(json.dumps(row), flush=True)
            check(len(results) == len(passes) == ROW_PASSES,
                  f"{name} sharded: {len(results)} passes, {len(passes)} "
                  f"read")
            for res, seen in zip(results, passes):
                check_pass(name, cfg, res, seen, smi, False, False)
                st = seen["stats"]
                if name not in CONSTRAINT_ROWS:
                    n = seen["launches"].get("claims", 0)
                    check(st.get("plain", 0) == st["batches"]
                          and n == st["waves"] * mesh.size,
                          f"{name} sharded: {n} claims launches for "
                          f"{st['waves']} waves on {mesh.size} shards "
                          f"({st.get('plain', 0)} of {st['batches']} "
                          f"batches plain)")
                    launches += n
                d = res["detail"]
                print(f"   {name} sharded pass {seen['pass']}: census "
                      f"{d.get('tpu_wave_collective_bytes')}; timeline "
                      f"device idle share {d.get('device_idle_share')}; "
                      f"waves {st['waves']} in {st['batches']} batches",
                      flush=True)
            check("error" not in row["detail"],
                  f"{name} sharded: {row['detail'].get('error')}")
            single = rows.get(name, {}).get("detail", {})
            d = row["detail"]
            print(f"   {name}: sharded {row['value']} pods/s, pod e2e "
                  f"p50/p99 {d.get('pod_e2e_p50_ms')} / "
                  f"{d.get('pod_e2e_p99_ms')} ms; single-device phase "
                  f"{'9' if name == 'Scheduling100k' else '15'} "
                  f"{rows.get(name, {}).get('value')} pods/s, "
                  f"{single.get('pod_e2e_p50_ms')} / "
                  f"{single.get('pod_e2e_p99_ms')} ms [{smi}]", flush=True)
    print(f"   phases 26-27 wall {time.monotonic() - t0:.3f} s", flush=True)
    return launches, err, {"random": offset_ms, "main path": shard_ms}


# -- phases 28-29: the snapshot API, the strict scan, the entry points --

SCAN_PODS = 4096         # phase 28(i): one batch of Scheduling100k's pods
SCAN_CPU_PODS = 256      # ... whose first pods the CPU scan repeats
SCAN_PROFILE_PODS = (32, 96)   # launches a pod: the difference of two runs
MIX_NODES, MIX_PODS = 5000, 1024   # phase 28(ii): phase (a)'s mix


def scan_bound(P, N, R):
    """(ms, "bytes" | "operations", bytes, ops) for a scan of P plain pods
    over N node rows: the node state read once (alloc and used [N, R],
    the used_nz cpu and memory columns, npods, maxpods, the static row
    byte) and the results written once (P assignments, used and npods);
    per (pod, node) cell 3R + 30 f32 operations (the mask's R subtracts,
    R compares and R ANDs, the pod cap, the two utilizations, both fit
    scores with their two fused multiply-adds counted as two operations
    each, the sqrt, the taint add, the feasible select and the running
    max)."""
    from kubernetes_tpu_torch.ops import kernels
    nbytes = N * (2 * R * 4 + 2 * 4 + 4 + 4 + 1) + P * 4 + N * (R * 4 + 4)
    ops = P * N * (3 * R + 30)
    ms, by = kernels.bound(nbytes, ops)
    return ms, by, nbytes, ops


def snapshot_inputs(cache, caps, infos):
    """(whole node arrays, PodBatch, ClusterTensors) of a cache's nodes
    and a list of PodInfo, from the port's flatten."""
    from kubernetes_tpu_torch.ops.flatten import BatchEncoder, ClusterTensors
    from kubernetes_tpu_torch.parallel.mesh import NODE_KEYS
    from kubernetes_tpu_torch.scheduler.cache import Snapshot
    t = ClusterTensors(caps)
    t.update_from_snapshot(cache.update_snapshot(Snapshot()))
    batch = BatchEncoder(t, len(infos)).encode(infos)
    check(not batch.escape, f"snapshot batch escapes: "
                            f"{dict(list(batch.escape_reasons.items())[:3])}")
    cd_sg, cd_asg = t.domain_base_counts()
    node = {k: getattr(t, k) for k in NODE_KEYS
            if k not in ("cd_sg", "cd_asg")}
    node.update(cd_sg=cd_sg, cd_asg=cd_asg)
    return node, batch, t


def check_capacity(node, used, npods, label):
    """No node over its CPU, memory or pod cap, from a result's state."""
    alloc, maxpods = np.asarray(node["alloc"]), np.asarray(node["maxpods"])
    over = ((used[:, :2] > alloc[:, :2]).any(1) | (npods > maxpods))
    check(not over.any(), f"{label}: {int(over.sum())} nodes over their "
                          f"cpu, memory or pod cap")


def scan_at_100k(dev, smi, n_nodes=100_000, pods=SCAN_PODS):
    """Phase 28(i): one batch of 4,096 Scheduling100k pods at 100,000
    nodes through build_assign_fn(mode="scan") on the card, every pod
    placed within capacity, the first 256 pods' assignments equal to the
    CPU scan's, ms and launches a pod, SyncGuard inside the pod loop.
    Returns the numbers for the K10 line."""
    from kubernetes_tpu_torch.models import assign
    from kubernetes_tpu_torch.ops.flatten import slice_pod_batch
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.testing.sanitizers import BuildCounter, SyncGuard
    from torch.profiler import ProfilerActivity, profile

    caps = caps_for_nodes(n_nodes)
    infos = make_batches(1, pods, "scan")[0]
    node, batch, _t = snapshot_inputs(build_cluster(n_nodes, 28), caps,
                                      infos)
    fn = assign.build_assign_fn(caps, mode="scan", device=dev)
    src, first = inspect.getsourcelines(assign._scan_pods)
    loop = range(first, first + len(src))
    torch.cuda.synchronize()
    with SyncGuard("warn") as guard, BuildCounter() as built:
        t0 = time.monotonic()
        out = fn(node, batch)
        wall = time.monotonic() - t0
    in_loop = {s: n for s, n in guard.sites.items() if s is not None
               and s[0].endswith("models/assign.py") and s[1] in loop}
    a = out["assignments"]
    check(bool((a >= 0).all()), f"scan 100k: {int((a < 0).sum())} of "
                                f"{pods} pods unplaced")
    check_capacity(node, out["used"], out["npods"], "scan 100k")
    guard_report(guard, built, "the scan at 100k nodes",
                 [(1, "call", "calls"), (pods, "pod", "pods")], smi)
    check(not in_loop, f"scan 100k: syncs inside the pod loop {in_loop}")
    t0 = time.monotonic()
    again = fn(node, batch)
    wall2 = time.monotonic() - t0
    check(np.array_equal(again["assignments"], a),
          "scan 100k: a second run placed differently")
    sub = slice_pod_batch(batch, 0, SCAN_CPU_PODS, SCAN_CPU_PODS)
    t0 = time.monotonic()
    cpu = assign.build_assign_fn(caps, mode="scan", device="cpu")(node, sub)
    cpu_s = time.monotonic() - t0
    diff = np.nonzero(cpu["assignments"] != a[:SCAN_CPU_PODS])[0]
    check(not diff.size, f"scan 100k: the first {SCAN_CPU_PODS} pods "
                         f"differ from the CPU scan at {diff[:8].tolist()}")
    kernels_by_run = []
    for n in SCAN_PROFILE_PODS:
        part = slice_pod_batch(batch, 0, n, n)
        fn(node, part)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(node, part)
            torch.cuda.synchronize()
        kernels_by_run.append(sum(
            1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA))
    lo, hi = SCAN_PROFILE_PODS
    per_pod = (kernels_by_run[1] - kernels_by_run[0]) / (hi - lo)
    ms_pod = wall2 * 1e3 / pods
    b_ms, b_by, b_bytes, b_ops = scan_bound(pods, caps.n_cap, caps.r)
    print(f"   scan 100k: {pods} pods over {caps.n_cap} rows "
          f"placed, within capacity; call wall {wall:.3f} s, again "
          f"{wall2:.3f} s: {ms_pod:.4f} ms a pod; device activities a "
          f"pod in the loop {per_pod:.2f} (profiler: {kernels_by_run} for "
          f"{list(SCAN_PROFILE_PODS)} pods); syncs inside the pod loop "
          f"{sum(in_loop.values())}, in the call {guard.syncs}; the CPU "
          f"scan of the first {SCAN_CPU_PODS} pods equal ({cpu_s:.3f} s); "
          f"bound {b_ms:.4f} ms for the batch ({b_by}: {b_bytes} B, "
          f"{b_ops} f32 operations) [{smi}]", flush=True)
    return {"name": "scan (K10, torch)", "ms_per_pod": ms_pod,
            "launches_per_pod": per_pod, "batch_ms": wall2 * 1e3,
            "syncs_in_loop": sum(in_loop.values()), "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": b_bytes,
            "bound_ops": b_ops, "pods": pods, "rows": caps.n_cap}


def snapshot_mix(dev, smi, n_nodes=MIX_NODES, pods=MIX_PODS):
    """Phase 28(ii): a 1,024-pod batch of phase (a)'s constraint mix at
    5,000 nodes: the scan on the card equal to the scan on the CPU (all
    three keys), the wave on the card equal to the wave on the CPU and to
    build_sharded_assign_fn on make_mesh("cuda:0"); both solvers'
    placements within capacity and the constraints."""
    from kubernetes_tpu_torch.models import assign
    from kubernetes_tpu_torch.parallel.mesh import (
        build_sharded_assign_fn, make_mesh,
    )
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.scheduler.types import PodInfo

    caps = caps_for_nodes(n_nodes)
    cache = build_zoned_cluster(n_nodes, 28, disk_labels=True)
    infos = [PodInfo(mixed_pod(f"m28-{i}", i)) for i in range(pods)]
    node, batch, t = snapshot_inputs(cache, caps, infos)
    outs = {}
    for mode in ("scan", "wave"):
        runs = []
        for device in (dev, torch.device("cpu")):
            t0 = time.monotonic()
            runs.append(assign.build_assign_fn(
                caps, mode=mode, device=device)(node, batch))
            print(f"   mix {mode} on {device.type}: "
                  f"{time.monotonic() - t0:.3f} s", flush=True)
        g, c = runs
        outs[mode] = g
        for k in c:
            check(np.array_equal(np.asarray(g[k]), np.asarray(c[k])),
                  f"mix {mode}: {k} differs between the card and the CPU")
    t0 = time.monotonic()
    one = make_mesh(dev)   # cuda:0 on the card
    sharded = build_sharded_assign_fn(caps, one, batch.p_cap)(node, batch)
    print(f"   mix sharded on {one}: {time.monotonic() - t0:.3f} s",
          flush=True)
    for k, v in outs["wave"].items():
        check(np.array_equal(np.asarray(v), np.asarray(sharded[k])),
              f"mix wave: {k} differs from the one-shard sharded form")
    for mode in ("scan", "wave"):
        out = outs[mode]
        rows = out["assignments"]
        check_capacity(node, out["used"], out["npods"], f"mix {mode}")
        names = [t.node_name(r) if r >= 0 else None for r in rows]
        spread = [nm for i, nm in enumerate(names) if i % 4 == 0 and nm]
        anti = [nm for i, nm in enumerate(names) if i % 4 == 1 and nm]
        check_constraints(cache, [[(nm, None) for nm in spread]],
                          f"mix {mode} spread", max_skew=1)
        check_constraints(cache, [[(nm, None) for nm in anti]],
                          f"mix {mode} anti", anti=True)
        print(f"   mix {mode}: placed {int((rows >= 0).sum())} of "
              f"{pods}; waves {out.get('waves', '-')}; the card equals "
              f"the CPU bit for bit [{smi}]", flush=True)


def snapshot_phases(dev, smi):
    """Phases 28-29.  28: the snapshot API on the card (scan_at_100k,
    snapshot_mix).  29: entry() on the card equal to entry(device="cpu"),
    then dryrun_multichip(4) on four shards of cuda:0 (n cards where that
    many are visible), the claims kernel's launches zeroed before it and
    read after it: at least one a shard.  Returns (the K10 numbers, the
    dry run's claims launches)."""
    from kubernetes_tpu_torch import entry as port_entry
    from kubernetes_tpu_torch.ops import kernels
    t0 = time.monotonic()
    with Phase("28 the snapshot API on the card"):
        gc.collect()
        torch.cuda.empty_cache()
        k10 = scan_at_100k(dev, smi)
        snapshot_mix(dev, smi)
    with Phase("29 the entry points: entry() and dryrun_multichip(4)"):
        fn, args = port_entry.entry()
        got = fn(*args)["assignments"]
        cfn, cargs = port_entry.entry(device="cpu")
        want = cfn(*cargs)["assignments"]
        check(np.array_equal(got, want),
              f"entry(): the card and the CPU differ at "
              f"{np.nonzero(got != want)[0][:8].tolist()}")
        print(f"   entry(): {int((got >= 0).sum())} of {len(got)} pods "
              f"placed, equal to entry(device='cpu') [{smi}]", flush=True)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        dry = port_entry.dryrun_multichip(4)
        launches = kernels.LAUNCHES["claims"]
        shards = len(dry["mesh"])
        check(launches >= shards, f"dryrun_multichip(4): {launches} claims "
                                  f"launches on {shards} shards")
        print(f"   dryrun_multichip(4) on {dry['mesh']}: {dry['seconds']:.3f}"
              f" s; claims launches {launches}; sharded {dry['sharded']}, "
              f"single {dry['single']}, ratio {dry['ratio']:.3f} [{smi}]",
              flush=True)
    print(f"   phases 28-29 wall {time.monotonic() - t0:.3f} s", flush=True)
    return k10, launches


FRONT_DOOR_RATES = {}   # phase 30's pods/s by row tag, read in phase 34
FRONT_DOOR_ROWS = (("i", "SchedulingBasicHTTP"),
                   ("ii", "SchedulingBasicHTTPProc"),
                   ("iii", "SchedulingBasicHTTP"))   # (iii): LocalClient


def front_door_phase(smi):
    """Phase 30: the front door on the card.  SchedulingBasicHTTP (i) and
    SchedulingBasicHTTPProc (ii) at bench.py's parameters (5,000 nodes,
    10,000 measured pods after the 1,000-pod warm-up, batch 4,096, depth
    2) through perf.bench.run_config: an apiserver with RBAC, the default
    admission chain and a WAL, in process (i) or in a process of its own
    (ii), and the scheduler's informers, binds and events and the
    submitter speaking HTTP to it; then (iii) the same workload and size
    through LocalClient.  The timeline is armed in all three, so the REST
    tax, (iii)'s pods/s over (i)'s and over (ii)'s, compares like with
    like.  Each row runs once, the kernels' counts zeroed just before it
    and read in its `after` hook, and is held to check_pass's invariants
    (every pod bound, none over CPU, memory or 110 pods, no ERROR status,
    escape rate 0, the claims kernel launched).  In (i) the in-process
    apiserver's GET /debug/timeline must hold the backend's device stages,
    and one claims wave recorded in (i) (ClaimsRecorder: the launch with
    the most live pods) replays equal to kernels.claims_reference; (ii)'s
    apiserver process must be gone after the row; and the phase must
    import no yaml module.  Returns {row tag: claims launches}."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.perf import bench
    from kubernetes_tpu_torch.scheduler.config import ProfilingPolicy

    def zero():
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
    yaml_before = {m for m in sys.modules if m.split(".")[0] == "yaml"}
    launches, rates = {}, {}
    with Phase("30 the front door on the card"):
        for tag, name in FRONT_DOOR_ROWS:
            gc.collect()
            torch.cuda.empty_cache()
            cfg = bench.CONFIGS[name]
            args = bench.pass_args(name)
            if tag == "iii":
                args["via_http"] = False
            label = (f"30({tag}) {name}" if tag != "iii" else
                     "30(iii) SchedulingBasicHTTP's workload via LocalClient")
            seen = {"pass": 1}

            def after(cluster, seen=seen, tag=tag, label=label):
                seen["launches"] = dict(kernels.LAUNCHES)
                seen["escapes"] = pass_escapes(cluster)
                front = cluster.front
                seen["proc"] = front and front.proc
                if tag == "i":
                    tl = cluster.client._request("GET", "/debug/timeline")
                    stages = {r["stage"] for r in tl["interval_rows"]}
                    check(tl["enabled"] and {"h2d", "device-step", "d2h"}
                          <= stages, f"{label}: /debug/timeline stages "
                                     f"{sorted(stages)}")
                    print(f"   {label}: the apiserver's /debug/timeline "
                          f"holds {len(tl['interval_rows'])} intervals, "
                          f"stages {sorted(stages)}, device idle share "
                          f"{tl.get('device_idle_share')}", flush=True)
            policy = ProfilingPolicy(timeline=True)
            with ClaimsRecorder(kernels, keep=tag == "i") as rec:
                zero()
                res = bench.run_once(**args, profiling_policy=policy,
                                     after=after)
            check("launches" in seen, f"{label}: {res.get('error')}")
            check_pass(name if tag != "iii" else f"{name} via LocalClient",
                       cfg, res, seen, smi, False, False)
            if tag == "ii":
                check(seen["proc"] is not None
                      and seen["proc"].poll() is not None,
                      f"{label}: the apiserver process outlived the row")
            if tag == "i":
                torch.cuda.synchronize()
                live = [int(r[3]) for r in rec.rows]
                k = max(range(len(live)), key=live.__getitem__)
                *wave, noise, pod_ids = rec.inputs[k]
                check_claims(kernels, tuple(wave), noise,
                             f"{label} recorded wave {k} "
                             f"({live[k]} live pods)", pod_ids)
                del rec.inputs[:], rec.outputs[:]
            d = res["detail"]
            launches[tag] = seen["launches"]["claims"]
            rates[tag] = res["value"]
            print(f"   {label}: {res['value']:.1f} pods/s, pod e2e p50 "
                  f"{d.get('pod_e2e_p50_ms')} ms p99 "
                  f"{d.get('pod_e2e_p99_ms')} ms, claims launches "
                  f"{launches[tag]}, wall {res['wall_s']} s [{smi}]",
                  flush=True)
        FRONT_DOOR_RATES.update(rates)
        print(f"   REST tax: LocalClient pods/s over the front door's: "
              f"(iii)/(i) {rates['iii'] / rates['i']:.4f}, (iii)/(ii) "
              f"{rates['iii'] / rates['ii']:.4f} [{smi}]", flush=True)
        yaml_after = {m for m in sys.modules if m.split(".")[0] == "yaml"}
        check(yaml_after == yaml_before,
              f"phase 30 imported {sorted(yaml_after - yaml_before)}")
    return launches


SCALEOUT_MAX = 4            # phase 31(i): run_scaleout(4): 1, 2, 4
SCALEOUT_TIMEOUT = 240.0    # a pass's barrier, s
SCALEOUT_WAVES = (2, 4)     # 31(iii): one recorded claims wave each
SCALEOUT_PROFILED = (1, 2)  # one profiled batch at these counts
CONFLICT_KINDS = ("lost_to_peer", "requeued", "fenced",
                  "already_bound_same_node")


class ScaleOutWatch:
    """Within the block: for each scale-out instance the longest gap
    between two of its coordinator's ticks (one a scheduling-loop
    iteration: the sweep and the resync run only there) and between two
    renewals of its lease (from the tick's heartbeat or the renewal
    thread's renew_off_loop, timed from when each read its clock), every
    membership change a tick reported, every _scaleout_resync with its
    seconds and the node count of the cache after it, and every garbage
    collection of 0.1 s or more; times from the last reset()."""

    def __enter__(self):
        from kubernetes_tpu_torch.scheduler.scaleout import \
            ScaleOutCoordinator
        from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
        self.classes = (ScaleOutCoordinator, Scheduler)
        tick = self.tick = ScaleOutCoordinator.tick
        resync = self.resync = Scheduler._scaleout_resync
        beat = self.beat = ScaleOutCoordinator.heartbeat
        renew = self.renew = ScaleOutCoordinator.renew_off_loop
        watch = self
        self.reset()

        def renewed(co, t):
            # t: when the renewal read its clock (the Lease's renewTime)
            last = watch.beats.get(co.index)
            if last is not None and t - last > watch.beat_gaps.get(
                    co.index, (0.0, 0.0))[0]:
                watch.beat_gaps[co.index] = (t - last, last - watch.t0)
            watch.beats[co.index] = t

        def timed_beat(co, client, now):
            t = time.monotonic()
            out = beat(co, client, now)
            renewed(co, t)
            return out

        def timed_renew(co, client, now=None):
            t = time.monotonic()
            out = renew(co, client, now)
            if out:
                renewed(co, t)
            return out

        def timed_tick(co, client, now=None):
            t = time.monotonic()
            last = watch.ticks.get(co.index)
            if last is not None and t - last > watch.gaps.get(
                    co.index, (0.0, 0.0))[0]:
                watch.gaps[co.index] = (t - last, last - watch.t0)
            watch.ticks[co.index] = t
            changed = tick(co, client, now)
            if changed:
                watch.changes.append((round(t - watch.t0, 3), co.index,
                                      co.live))
            return changed

        def timed_resync(sched):
            t = time.monotonic()
            resync(sched)
            watch.resyncs.append((round(t - watch.t0, 3),
                                  sched.scaleout.index, sched.scaleout.live,
                                  time.monotonic() - t,
                                  sched.cache.node_count()))
        ScaleOutCoordinator.tick = timed_tick
        ScaleOutCoordinator.heartbeat = timed_beat
        ScaleOutCoordinator.renew_off_loop = timed_renew
        Scheduler._scaleout_resync = timed_resync
        gc.callbacks.append(self.on_gc)
        return self

    def __exit__(self, *exc):
        self.classes[0].tick = self.tick
        self.classes[0].heartbeat = self.beat
        self.classes[0].renew_off_loop = self.renew
        self.classes[1]._scaleout_resync = self.resync
        gc.callbacks.remove(self.on_gc)
        return False

    def reset(self):
        self.t0 = time.monotonic()
        self.ticks, self.gaps, self.changes = {}, {}, []
        self.resyncs, self.gcs, self.gc_t = [], [], None
        self.beats, self.beat_gaps = {}, {}

    def on_gc(self, phase, info):
        if phase == "start":
            self.gc_t = time.monotonic()
        elif self.gc_t is not None:
            secs = time.monotonic() - self.gc_t
            if secs >= 0.1:
                self.gcs.append((round(self.gc_t - self.t0, 3),
                                 info["generation"], round(secs, 3)))

    def report(self, label, smi):
        gaps = {i: f"{g:.3f} s at {at:.3f}" for i, (g, at) in
                sorted(self.gaps.items())}
        beats = {i: f"{g:.3f} s at {at:.3f}" for i, (g, at) in
                 sorted(self.beat_gaps.items())}
        print(f"   {label}: longest gap between lease ticks per instance "
              f"{gaps}, between lease renewals {beats}; membership "
              f"changes (s, instance, live) "
              f"{self.changes[:12]}{' ...' if len(self.changes) > 12 else ''}"
              f" ({len(self.changes)}); gc pauses >= 0.1 s, longest first "
              f"(s, gen, secs) {sorted(self.gcs, key=lambda g: -g[2])[:8]} "
              f"({len(self.gcs)}) [{smi}]", flush=True)
        for at, idx, live, secs, held in self.resyncs[:12]:
            print(f"   {label}: resync at {at} s: instance {idx} live {live}"
                  f" took {secs:.3f} s, its cache {held} nodes", flush=True)
        if len(self.resyncs) > 12:
            print(f"   {label}: {len(self.resyncs)} resyncs in all",
                  flush=True)


def instance_backends(clusters):
    return [cl.scheduler.profiles["default-scheduler"].batch_backend
            for cl in clusters]


def check_instances(clusters, label, ran=None, device_type="cuda"):
    """No fallback: every instance's batch backend is a TorchBatchBackend
    on the card (on `device_type`), each instance in `ran` (default: all) ran batches, every
    one of them plain, and no instance sent a pod to the per-pod path: a
    batch whose cache outgrew the backend's n_cap (a peer's slices
    absorbed past it) escapes whole as ("BatchEncoder", "vocab_full")
    before it counts as a batch.  Returns (batches, waves) per
    instance."""
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    out = []
    for i, (cl, b) in enumerate(zip(clusters, instance_backends(clusters))):
        check(type(b) is TorchBatchBackend
              and b.device.type == device_type,
              f"{label}: instance {i}'s backend is {type(b).__name__} on "
              f"{getattr(b, 'device', None)}")
        st = b.stats
        check(st.get("plain", 0) == st["batches"]
              and (st["batches"] > 0 or (ran is not None and i not in ran)),
              f"{label}: instance {i} batches {st['batches']} plain "
              f"{st.get('plain', 0)}")
        cl.scheduler._drain_backend_telemetry(b)  # tallies not yet drained
        esc = pass_escapes(cl)
        check(esc["escaped"] == 0 and not esc["by_reason"],
              f"{label}: instance {i} sent pods to the per-pod path: "
              f"{esc}")
        out.append((st["batches"], st["waves"]))
    return out


def conflict_counts(clusters):
    """Per conflict kind, the sum over the instances' counters."""
    out = dict.fromkeys(CONFLICT_KINDS, 0)
    for cl in clusters:
        for (kind,), v in cl.scheduler.metrics.prom.bind_conflict_total \
                .values().items():
            out[kind] = out.get(kind, 0) + int(v)
    return out


def profile_instances(clusters, n_pods, label, smi, timeout=120.0):
    """One more batch of n_pods of the flood's shape (10m, 16Mi) across
    every running instance under torch.profiler: wall from the create to
    the last pod's scheduling attempt on whichever instance owns it, the
    device busy time of the kernels and copies in it, and the idle share
    (1 - busy / wall), as perf.bench.profile_batch reads it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.client.clientset import PODS
    from kubernetes_tpu_torch.testing import make_pod

    def attempted():
        total = 0
        for cl in clusters:
            with cl.scheduler.metrics.lock:
                total += cl.scheduler.metrics.schedule_attempts.get(
                    "scheduled", 0)
        return total
    pods = [make_pod(f"prof-{label}-{i}").req(cpu="10m", mem="16Mi").build()
            for i in range(n_pods)]
    base = attempted()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        clusters[0].client.create_bulk(PODS, pods)
        deadline = t0 + timeout
        while attempted() < base + n_pods and time.monotonic() < deadline:
            time.sleep(0.002)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    check(attempted() >= base + n_pods,
          f"{label}: the profiled batch did not finish in {timeout} s")
    busy_ms = sum(e.self_device_time_total / 1e3
                  for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU
                  and e.self_device_time_total > 0
                  and not e.key.startswith("full."))
    idle = 1 - busy_ms / wall_ms
    print(f"   {label}: profiled batch of {n_pods} pods over "
          f"{len(clusters)} instance(s): wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {idle:.4f} [{smi}]", flush=True)
    return idle


def scaleout_flood(smi, watch, nodes, pods, batch, timeout):
    """31(i): perf.bench.run_scaleout(4) on the card.  Each pass is
    checked and printed when its row is read, before its clusters shut
    down: pods/s, wall, bound pods, the conflict taxonomy, speedup_vs_1
    (at the end), the claims launches (counts zeroed when the pass
    starts), the pass's peak of allocated device memory and the watch's
    lease ticks, membership changes, resyncs and collections; every pod
    bound and no node over its CPU, memory or pod cap (read from the
    store before the profiled batch); every instance's backend a
    TorchBatchBackend on the card with plain batches only; then one
    profiled batch at N=1 and N=2 (the device's idle share).  One claims
    wave of an instance is recorded at N=2 and at N=4 (31(iii))."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.perf import bench
    seen = {}

    def before(n):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        rec.armed = n if n in SCALEOUT_WAVES else None
        watch.reset()

    def after(n, row, clusters, store):
        torch.cuda.synchronize()
        label = f"31(i) N={n}"
        got = seen[n] = {"launches": kernels.LAUNCHES["claims"],
                         "peak": torch.cuda.max_memory_allocated(),
                         "caps": instance_backends(clusters)[0].caps.n_cap}
        watch.report(label, smi)
        placed = bench.check_placements(store, pods)
        conflicts = conflict_counts(clusters)
        per = check_instances(clusters, label)
        print(f"   {label}: {row['pods_per_s']} pods/s, wall {row['wall_s']}"
              f" s, bound {row['bound']}; conflicts {conflicts} (federated "
              f"{row['conflicts']}, rate {row['conflict_rate']}); claims "
              f"launches {got['launches']}; batches / waves per instance "
              f"{per}; n_cap {got['caps']}; nodes used "
              f"{placed['nodes_used']}, most pods on a node "
              f"{placed['max_pods_per_node']}; peak device memory "
              f"{got['peak'] / 2**30:.3f} GiB [{smi}]", flush=True)
        if conflicts["fenced"]:
            print(f"   {label}: FINDING: {conflicts['fenced']} pod binds "
                  f"fenced with no churn (an instance outlived its own "
                  f"lease)", flush=True)
        check("error" not in row, f"{label}: {row.get('error')}")
        check(row["bound"] >= pods and placed["bound"] == placed["pods"]
              == pods, f"{label}: bound {row['bound']}, placements {placed}")
        check(placed["nodes_over_capacity"] == 0,
              f"{label}: nodes over capacity {placed['over_examples']}")
        check(got["launches"] > 0,
              f"{label}: the claims kernel never launched")
        if n in SCALEOUT_PROFILED:
            got["idle"] = profile_instances(clusters, PROFILED_PODS,
                                            f"scaleout-{n}", smi)
    with ClaimsRecorder(kernels, first_live=True) as rec:
        res = bench.run_scaleout(SCALEOUT_MAX, nodes=nodes, pods=pods,
                                 batch=batch, timeout=timeout,
                                 before=before, after=after)
    print("   31(i) speedup_vs_1: " + ", ".join(
        f"N={n} {row.get('speedup_vs_1')}"
        for n, row in res["BENCH_SCALEOUT"].items()) + f" [{smi}]",
        flush=True)
    if all(n in seen for n in SCALEOUT_PROFILED):
        print(f"   31(i) idle share N=1 {seen[1]['idle']:.4f}, N=2 "
              f"{seen[2]['idle']:.4f} [{smi}]", flush=True)
    return res, seen, rec.kept


def scaleout_churn(smi, watch, nodes, pods, batch, timeout, n=2):
    """31(ii): n instances at full width with an InstanceChurner
    (script {1: kill instance 0}, min_live 1) stepped once a 10,000-pod
    chunk of the flood; a kill holds the flood until every live survivor
    has swept the victim out; instance 0 revives after the flood.  Each
    instance's backend holds the whole cluster (caps_for_nodes(nodes)):
    bench.py's 1.6/n sizing leaves no room for a dead peer's slices, and
    a cache past n_cap sends every batch to the per-pod path.  Every
    pod bound exactly once (bench.BindLedger over the store's whole pod
    history: no nodeName ever moved node to node, none lost), the
    survivor's cache holding every node after the kill, every node
    within its caps, the fenced and requeued counts and each resync's
    time printed.  Returns the claims launches."""
    from kubernetes_tpu_torch.client.clientset import NODES, PODS, \
        LocalClient
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.faults import (
        KILL_INSTANCE, InstanceChurner, ScaleOutSchedule,
    )
    from kubernetes_tpu_torch.perf import bench, caps_for_nodes
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        ThroughputCollector, setup_cluster,
    )
    from kubernetes_tpu_torch.scheduler.config import ScaleOutPolicy
    from kubernetes_tpu_torch.store import kv
    from kubernetes_tpu_torch.testing import make_node, make_pod
    label = f"31(ii) N={n} churn"
    gc.collect()
    torch.cuda.empty_cache()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    watch.reset()
    store = kv.MemoryStore(history=2_000_000)
    admin = LocalClient(store)
    ledger = bench.BindLedger(store, since_rv=0)
    caps = caps_for_nodes(nodes)
    clusters = []
    chunk = bench.SCALEOUT_CHUNK
    try:
        for i in range(n):
            cl = setup_cluster(caps=caps, batch_size=batch, store=store,
                               pipeline_depth=2)
            clusters.append(cl)
            cl.scheduler.configure_scaleout(ScaleOutPolicy(
                instance_count=n, instance_index=i,
                ring_slices=max(64, 16 * n)))
        for lo in range(0, nodes, chunk):
            admin.create_bulk(NODES, [
                make_node(f"sn-{i}")
                .capacity(cpu="64", mem="256Gi", pods=1000).build()
                for i in range(lo, min(lo + chunk, nodes))])
        time.sleep(1.0 + nodes / 50_000)
        cos = [cl.scheduler.scaleout for cl in clusters]
        churner = InstanceChurner(cos, ScaleOutSchedule(
            instance_count=n, script={1: (KILL_INSTANCE, 0)}), min_live=1)
        collector = ThroughputCollector(store)
        collector.start()
        t0 = time.monotonic()
        for lo in range(0, pods, chunk):
            admin.create_bulk(PODS, [
                make_pod(f"sp-{i}").req(cpu="10m", mem="16Mi").build()
                for i in range(lo, min(lo + chunk, pods))])
            act = churner.step()
            if act and act[0] == KILL_INSTANCE:
                victim, t_kill = act[1], time.monotonic()
                survivors = [c for c in cos
                             if c.index != victim and c.self_live]
                while not all(victim not in c.live for c in survivors):
                    check(time.monotonic() - t_kill < 60.0,
                          f"{label}: the survivors never swept instance "
                          f"{victim} out")
                    time.sleep(0.01)
                swept = time.monotonic() - t_kill
                surv = clusters[survivors[0].index].scheduler
                while surv.cache.node_count() < nodes:
                    check(time.monotonic() - t_kill < 120.0,
                          f"{label}: the survivor's cache holds "
                          f"{surv.cache.node_count()} of {nodes} nodes")
                    time.sleep(0.01)
                held, _, _ = surv.cache.comparison_snapshot()
                check(len(held) == nodes, f"{label}: survivor holds "
                                          f"{len(held)} nodes")
                print(f"   {label}: killed instance {victim} after "
                      f"{lo + chunk} pods ({round(t_kill - watch.t0, 3)} s "
                      f"into the pass); survivors swept it out in "
                      f"{swept:.3f} s, the survivor's cache held all "
                      f"{len(held)} nodes after "
                      f"{time.monotonic() - t_kill:.3f} s", flush=True)
        for c in cos:
            c.revive()
        ok = False
        while time.monotonic() - t0 < timeout:
            if collector.bound_total() >= pods:
                ok = True
                break
            time.sleep(0.25)
        elapsed = time.monotonic() - t0
        collector.stop()
        torch.cuda.synchronize()
        launches = kernels.LAUNCHES["claims"]
        watch.report(label, smi)
        check(ok, f"{label}: {collector.bound_total()} of {pods} bound in "
                  f"{timeout} s; churn log {churner.log}")
        ledger.drain()
        check(not ledger.rebinds, f"{label}: pods bound to two nodes "
                                  f"{ledger.rebinds[:5]}")
        check(len(ledger.bound) == pods, f"{label}: {len(ledger.bound)} of "
                                         f"{pods} pods ever bound")
        placed = bench.check_placements(store, pods)
        check(placed["bound"] == pods and placed["nodes_over_capacity"] == 0,
              f"{label}: placements {placed}")
        check(churner.injected[KILL_INSTANCE] == 1,
              f"{label}: churn {churner.injected}")
        check(launches > 0, f"{label}: the claims kernel never launched")
        check(watch.resyncs, f"{label}: no membership change resynced")
        inst = check_instances(clusters, label, ran=(1,))
        per = [conflict_counts([cl]) for cl in clusters]
        print(f"   {label}: {pods} pods bound exactly once in "
              f"{elapsed:.3f} s ({pods / elapsed:.1f} pods/s); churn log "
              f"{churner.log}; conflicts {conflict_counts(clusters)} "
              f"(instance 0: fenced {per[0]['fenced']}, requeued "
              f"{per[0]['requeued']}; instance 1: fenced {per[1]['fenced']},"
              f" requeued {per[1]['requeued']}); batches / waves per "
              f"instance {inst}; claims launches {launches} [{smi}]",
              flush=True)
        return launches
    finally:
        bench.shutdown_all(clusters)
        ledger.stop()


def scaleout_phase(smi, nodes=100_000, pods=200_000, batch=16384,
                   timeout=SCALEOUT_TIMEOUT):
    """Phase 31: in-process scale-out on the card (scheduler/scaleout.py,
    perf.bench.run_scaleout): (i) the flood through 1, 2 and 4 instances
    over one store, (ii) two instances with instance 0 killed and revived
    mid-flood, (iii) the recorded waves of (i) at N=2 and N=4 replayed
    through the claims kernel against its plain version at each
    instance's own n_cap, timed beside the plain version and the bound.
    Returns (claims launches of (i) and (ii), max |best err| of (iii))."""
    from kubernetes_tpu_torch.ops import kernels
    with Phase("31 in-process scale-out on the card"), \
            ScaleOutWatch() as watch:
        res, seen, waves = scaleout_flood(smi, watch, nodes, pods, batch,
                                          timeout)
        launches = sum(got["launches"] for got in seen.values())
        launches += scaleout_churn(smi, watch, nodes, pods, batch, timeout)
        errs = []
        for n in SCALEOUT_WAVES:
            check(n in waves, f"31(iii) N={n}: no claims wave recorded")
            *wave, noise, pod_ids = waves.pop(n)
            args = tuple(wave)
            P, N, _R = args[0]["shape"]
            label = f"31(iii) N={n} recorded wave {P}x{N}"
            err, *answer = check_claims(kernels, args, noise, label, pod_ids)
            errs.append(err)
            ms = time_cuda(lambda: kernels.claims(
                *args, noise=noise, pod_ids=pod_ids), 20)
            plain_ms = time_cuda(lambda: kernels.claims_reference(
                *args, noise=noise, pod_ids=pod_ids), 3, warmup=1)
            b = claims_bounds(args, noise, answer)
            print(f"   {label} {noise}: live pods "
                  f"{int(args[1].sum())}, n_cap {seen[n]['caps']}: "
                  f"{ms:.4f} ms/launch, plain version {plain_ms:.4f} ms, "
                  f"bound {b['required'][0]:.4f} ms ({b['required'][1]}) "
                  f"[{smi}]", flush=True)
            del wave, args, answer
        torch.cuda.empty_cache()
    return launches, max(errs)


BINARY_NODES = 5000       # phase 32: Kubernetes v1.26's largest cluster
BINARY_WARM = 1000        # warm-up pods, bound before the flood
BINARY_FLOOD = 20_000     # the flood
BINARY_KILL_AT = 5000     # the leader dies once this many flood pods bound
BINARY_BATCH = 4096
BINARY_STEP_S = 120.0     # every wait of phase 32, s
BINARY_TERM_S = 10.0      # SIGTERM to exit, s
BINARY_ADMIN = "phase32-admin"
BINARY_SCHED = "phase32-scheduler"
CHILD_TAG = "binary-child: "
CHILD_BATCH_TAG = "binary-child batch: "
CHILD_MEMORY_TAG = "binary-child memory MiB: "


def instrument_child(batch_tag, record=False):
    """In a scheduler child's process (phases 32 and 33): every Scheduler
    made is kept, the claims launches are counted from the end of the
    backend's warmup (kernels.LAUNCHES zeroed there), and after every
    batch the loop retires (its escapes are tallied by then, before any
    of them reaches the per-pod path) the counts so far are printed on
    one line, `batch_tag` and a JSON object: claims launches, batches,
    plain batches, waves and escapes, in total and by reason, the
    backend's device and the torch allocator's reserved and peak MiB.  A
    process that is killed leaves its last such line.  With `record`, the
    returned ClaimsRecorder (enter it around the child's main) keeps the
    inputs of the first claims launch with a live pod after the warmup.
    Returns (counts, finish, recorder): finish() drains the backends'
    telemetry the loop had not drained; call it once main returns."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    made = []
    init, warmup = Scheduler.__init__, TorchBatchBackend.warmup
    drain = Scheduler._drain_backend_telemetry
    rec = ClaimsRecorder(kernels, first_live=True)

    def counts():
        out = {"launches": dict(kernels.LAUNCHES), "escaped": 0,
               "by_reason": {}, "batches": 0, "plain": 0, "waves": 0}
        for sched in made:
            for prof in sched.profiles.values():
                b = prof.batch_backend
                if b is None:
                    continue
                out["escaped"] += b.stats.get("escaped", 0)
                for k in ("batches", "plain", "waves"):
                    out[k] += b.stats.get(k, 0)
                out["device"] = str(b.device)
            for k, v in sched.metrics.prom.tpu_escape_total.values().items():
                out["by_reason"]["/".join(k)] = v
        if torch.cuda.is_initialized():
            out["reserved_mib"] = torch.cuda.memory_reserved() / 2**20
            out["peak_reserved_mib"] = \
                torch.cuda.max_memory_reserved() / 2**20
        return out

    def made_too(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    def warm_then_zero(self):
        warmup(self)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        if record:
            rec.armed = "wave"

    def drain_then_count(self, backend):
        escapes = drain(self, backend)
        print(batch_tag + json.dumps(counts()), flush=True)
        return escapes

    def finish():
        for sched in made:
            for prof in sched.profiles.values():
                if prof.batch_backend is not None:
                    drain(sched, prof.batch_backend)
    Scheduler.__init__ = made_too
    TorchBatchBackend.warmup = warm_then_zero
    Scheduler._drain_backend_telemetry = drain_then_count
    return counts, finish, rec


def binary_child(argv):
    """--binary-child ARGS: kubernetes_tpu_torch.cmd.scheduler.main(ARGS),
    unchanged, instrumented by instrument_child: its counts after every
    batch (CHILD_BATCH_TAG) and, once main returns, after CHILD_TAG.
    Each SIGUSR2 also prints the process's torch allocator memory
    (CHILD_MEMORY_TAG)."""
    from kubernetes_tpu_torch.cmd import scheduler as cmd
    from kubernetes_tpu_torch.scheduler.debugger import CacheDebugger

    log_all = CacheDebugger.log_all

    def log_all_and_memory(self, *a):
        log_all(self, *a)
        mib = {}
        if torch.cuda.is_initialized():
            mib = {"reserved": torch.cuda.memory_reserved() / 2**20,
                   "peak_reserved": torch.cuda.max_memory_reserved() / 2**20,
                   "allocated": torch.cuda.memory_allocated() / 2**20}
        print(CHILD_MEMORY_TAG + json.dumps(mib), flush=True)
    counts, finish, _rec = instrument_child(CHILD_BATCH_TAG)
    CacheDebugger.log_all = log_all_and_memory
    cmd.main(argv)
    finish()
    print(CHILD_TAG + json.dumps(counts()), flush=True)
    return 0


class ChildLog:
    """A child process whose output lines are kept, each with the
    monotonic time it arrived; the caller never blocks on the pipe
    (tests/test_torch_cmd_scheduler.py runs its binaries through it)."""

    def __init__(self, argv, name, cwd):
        self.name = name
        self.proc = subprocess.Popen(argv, cwd=cwd, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.monotonic(), line.rstrip("\n")))

    def find(self, pattern, since=0):
        for t, line in self.lines[since:]:
            hit = re.search(pattern, line)
            if hit:
                return t, hit
        return None

    def last(self, pattern):
        """The last line matching `pattern`, as find returns it."""
        for t, line in reversed(self.lines[:]):
            hit = re.search(pattern, line)
            if hit:
                return t, hit
        return None

    def wait_line(self, pattern, what, since=0, timeout=BINARY_STEP_S):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = self.find(pattern, since)
            if got is not None:
                return got
            if self.proc.poll() is not None and not self._reader.is_alive():
                break
            time.sleep(0.02)
        tail = "\n".join(line[:400] for _t, line in self.lines[-30:])
        raise SystemExit(f"CHECK FAILED: {self.name}: {what} (no line "
                         f"matching {pattern!r} within {timeout} s; rc "
                         f"{self.proc.poll()}); its last lines:\n{tail}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._reader.join(timeout=5)


class BindWatch:
    """Every pod's nodeName as a watch on the apiserver sees it: the time
    each pod was first seen and first seen bound, the binds a pod got
    (an unbound pod becoming bound), and any change of a set nodeName
    (phase 32 and tests/test_torch_cmd_scheduler.py)."""

    phase = "32"            # the phase named in a failed wait's message
    step_s = BINARY_STEP_S  # wait_until's default bound, s

    def __init__(self, client):
        self.watch = client.watch("pods")
        self.added, self.bound_at, self.node = {}, {}, {}
        self.binds, self.changed = {}, []
        self._stop = threading.Event()
        self.error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                evs = self.watch.next_batch(timeout=0.1)
                now = time.monotonic()
                for ev in evs:
                    self._event(ev, now)
        except Exception as e:  # noqa: BLE001 - reported by the phase
            self.error = repr(e)

    def _event(self, ev, now):
        md = ev.object["metadata"]
        key = f"{md['namespace']}/{md['name']}"
        self.added.setdefault(key, now)
        node = (ev.object.get("spec") or {}).get("nodeName")
        old = self.node.get(key)
        if node and old and node != old:
            self.changed.append((key, old, node))
        if node and not old:
            self.binds[key] = self.binds.get(key, 0) + 1
            self.bound_at.setdefault(key, now)
            self.node[key] = node
        return key

    def bound(self, prefix=""):
        return sum(1 for k in list(self.bound_at) if k.startswith(prefix))

    def wait_bound(self, want, prefix, what, alive,
                   timeout=BINARY_STEP_S):
        """Wait until `want` pods under `prefix` are bound."""
        return self.wait_until(
            lambda: self.bound(prefix) >= want,
            lambda: f"{what}: {self.bound(prefix)} of {want} bound", alive,
            timeout)

    def wait_until(self, done, what, alive, timeout=None, poll=0.005):
        """Wait until done() holds, asking every `poll` s, at most
        `timeout` s (step_s by default); `what` (or what(), when it is
        callable) names the wait in a failure, and `alive()` fails the
        phase when a child it expects to run has exited.  Returns the
        time done() first held."""
        timeout = self.step_s if timeout is None else timeout
        deadline = time.monotonic() + timeout
        while not done():
            alive()
            check(self.error is None, f"{self.phase}: the pods watch "
                                      f"failed: {self.error}")
            check(time.monotonic() < deadline,
                  f"{self.phase}: {what() if callable(what) else what} "
                  f"after {timeout} s")
            time.sleep(poll)
        return time.monotonic()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.watch.stop()


def device_memory():
    """The card's memory in use (MiB, nvidia-smi's memory.used) and the
    compute-apps rows (pid, MiB) as nvidia-smi prints them: inside a
    container the pids may be its own namespace's, not the children's."""
    used = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return float(used), apps.replace("\n", "; ")


def usr2_verdict(child, what):
    """SIGUSR2 to the binary; its cache comparer's line and its torch
    allocator's memory (binary_child prints it after the comparison)."""
    since = len(child.lines)
    child.proc.send_signal(signal.SIGUSR2)
    _t, hit = child.wait_line(r"cache comparer: (.*)", what, since)
    _t, mib = child.wait_line(re.escape(CHILD_MEMORY_TAG) + "(.*)",
                              f"{what}: its memory line", since)
    return hit[1], json.loads(mib[1])


def check_in_sync(child, what, tries=3):
    """The binary's cache must compare in sync with the apiserver.  A
    comparison may race an informer event still in flight, so it is
    asked again after a second, up to `tries` times; every answer is
    printed.  Returns the binary's torch allocator memory (MiB)."""
    for i in range(tries):
        verdict, mib = usr2_verdict(child, what)
        print(f"   {what}: SIGUSR2 ({i + 1}): {verdict[:300]}; torch "
              f"allocator MiB {mib}", flush=True)
        if verdict.startswith("cache is in sync with apiserver"):
            return mib
        time.sleep(1.0)
    raise SystemExit(f"CHECK FAILED: 32 {what}: cache not in sync after "
                     f"{tries} comparisons")


def check_binary_caps(client, want, label):
    """Every pod bound, on a node of the cluster, within its CPU, memory
    and pod caps (every pod asks 100m / 128Mi)."""
    from kubernetes_tpu_torch.api import meta
    from kubernetes_tpu_torch.api.quantity import parse_quantity
    pods, _ = client.list("pods")
    nodes = {meta.name(n): n for n in client.list("nodes")[0]}
    check(len(pods) == want, f"{label}: {len(pods)} pods, {want} expected")
    used = {}
    for p in pods:
        node = meta.pod_node_name(p)
        check(node in nodes, f"{label}: {meta.name(p)} on {node!r}")
        req = p["spec"]["containers"][0]["resources"]["requests"]
        u = used.setdefault(node, [0.0, 0.0, 0])
        u[0] += parse_quantity(req["cpu"])
        u[1] += parse_quantity(req["memory"])
        u[2] += 1
    for node, (cpu, mem, n) in used.items():
        cap = nodes[node]["status"]["allocatable"]
        check(cpu <= parse_quantity(cap["cpu"]) + 1e-9
              and mem <= parse_quantity(cap["memory"])
              and n <= int(cap["pods"]),
              f"{label}: node {node} over its caps: cpu {cpu} memory "
              f"{mem} pods {n}")
    return len(used)


def apiserver_child(tmp, tokens, name, root):
    """The port's apiserver as a process on a free port (phases 32 and
    35): RBAC over a token file of the lines `tokens`, the default
    admission chain less the harness's list, a WAL under `tmp`.  Returns
    its ChildLog, not yet listening, and its URL."""
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        _HARNESS_DISABLED_ADMISSION)
    token_file = Path(tmp) / "tokens.csv"
    token_file.write_text("".join(f"{line}\n" for line in tokens))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    api = ChildLog(
        [sys.executable, "-u", "-m", "kubernetes_tpu_torch.cmd.apiserver",
         "--secure-port", str(port), "--token-file", str(token_file),
         "--authorization-mode", "RBAC", "--enable-default-admission",
         "--disable-admission-plugins",
         ",".join(_HARNESS_DISABLED_ADMISSION), "--data-dir",
         str(Path(tmp) / "wal")], name, root)
    return api, f"http://127.0.0.1:{port}"


def alive_check(children, killed):
    """A check that every child ChildLog runs, bar those in `killed`."""
    def alive():
        for child in children:
            rc = child.proc.poll()
            check(rc is None or child in killed,
                  f"{child.name} exited {rc}; its last lines: "
                  f"{[line[:300] for _t, line in child.lines[-8:]]}")
    return alive


def binary_phase(smi, nodes=BINARY_NODES, warm=BINARY_WARM,
                 flood=BINARY_FLOOD, kill_at=BINARY_KILL_AT,
                 batch=BINARY_BATCH, device="cuda"):
    """Phase 32: the scheduler's binary as a deployment on the card.  The
    port's apiserver runs as a process (RBAC, the default admission chain
    less the harness's list, a WAL), and two scheduler binaries, A and B
    (python -m kubernetes_tpu_torch.cmd.scheduler, started through this
    script's --binary-child entry, which counts their claims launches),
    run behind it with --tpu-batch --leader-elect --batch-size 4096
    --node-capacity caps_for_nodes(nodes).n_cap, each under
    system:kube-scheduler's own token.  On 5,000 nodes of
    SchedulingBasicHTTP's shape: the leader is named by its "became
    leader" line and the Lease's holderIdentity; 1,000 warm-up pods are
    bound; both caches compare in sync on SIGUSR2; a flood of 20,000
    pods starts and the leader is SIGKILLed once 5,000 of them are
    bound; the follower must lead (its own line and the Lease) and bind
    the rest.  Every pod is bound exactly once within caps and no pod's
    nodeName changes, as a watch sees them; the survivor's cache compares
    in sync and SIGTERM ends it with 0 within 10 s.  Each binary's
    claims launches must be more than 0 and its escapes 0: the survivor's
    as it exits, the killed leader's as of the last batch it retired
    (binary_child prints them after every batch; a pod escaped to the
    per-pod path is counted before it gets there).  Returns the two
    binaries' claims launches."""
    import tempfile

    from kubernetes_tpu_torch.client.http_client import HTTPClient
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        _bulk_create, _default_node, _default_pod)

    root = str(Path(__file__).resolve().parent)
    n_cap = caps_for_nodes(nodes).n_cap
    children, watch = [], None
    with Phase("32 the scheduler's binary"), \
            tempfile.TemporaryDirectory(prefix="phase32-") as tmp:
        try:
            api, url = apiserver_child(
                tmp, (f"{BINARY_ADMIN},phase32,system:masters",
                      f"{BINARY_SCHED},system:kube-scheduler"),
                "32 apiserver", root)
            children.append(api)
            killed = set()
            alive = alive_check(children, killed)
            api.wait_line("apiserver listening on", "the apiserver start")
            admin = HTTPClient.from_url(url, token=BINARY_ADMIN)
            t0 = time.monotonic()
            _bulk_create(admin, "nodes", nodes, 0, _default_node, {})
            print(f"   {nodes} nodes created in "
                  f"{time.monotonic() - t0:.3f} s", flush=True)
            watch = BindWatch(admin)
            used0, _apps = device_memory()
            me = str(Path(__file__).resolve())
            binaries = {}
            for tag in ("A", "B"):
                binaries[tag] = ChildLog(
                    [sys.executable, "-u", me, "--binary-child", "--server",
                     url, "--token", BINARY_SCHED, "--tpu-batch",
                     "--leader-elect", "--batch-size", str(batch),
                     "--node-capacity", str(n_cap), "--device", device],
                    f"32 binary {tag}", root)
                children.append(binaries[tag])
            for tag, b in binaries.items():
                t, _ = b.wait_line(r"scheduler running \(tpu-batch profile\)",
                                   "the binary's start")
                print(f"   binary {tag} (pid {b.proc.pid}) running "
                      f"{t - t0:.3f} s after the nodes were sent "
                      f"(n_cap {n_cap}, batch {batch})", flush=True)
            # the leader: its own line and the Lease's holder
            deadline = time.monotonic() + BINARY_STEP_S
            led = {}
            while not led:
                led = {tag: b.find(r"(kube-scheduler-[0-9a-f]+) became "
                                   r"leader") for tag, b in binaries.items()}
                led = {tag: got for tag, got in led.items() if got}
                check(time.monotonic() < deadline,
                      "32: no binary became leader")
                alive()
                time.sleep(0.02)
            check(len(led) == 1, f"32: two leaders: {sorted(led)}")
            (lead_tag, (_t, hit)), = led.items()
            ident = {lead_tag: hit[1]}
            lease = admin.get("leases", "kube-system", "kube-scheduler")
            check(lease["spec"]["holderIdentity"] == ident[lead_tag],
                  f"32: the Lease is held by "
                  f"{lease['spec']['holderIdentity']}, binary {lead_tag} "
                  f"said {ident[lead_tag]}")
            follow_tag = "B" if lead_tag == "A" else "A"
            leader, follower = binaries[lead_tag], binaries[follow_tag]
            print(f"   leader: binary {lead_tag} ({ident[lead_tag]}, the "
                  f"Lease's holder); follower: binary {follow_tag}",
                  flush=True)

            _bulk_create(admin, "pods", warm, 0, _default_pod,
                         {"podNamePrefix": "warm-"})
            watch.wait_bound(warm, "default/warm-", "the warm-up", alive)
            time.sleep(1.0)
            torch_mib = {tag: check_in_sync(b, f"binary {tag} after the "
                                               f"warm-up")
                         for tag, b in binaries.items()}
            used2, apps2 = device_memory()
            check(not follower.find("became leader"),
                  "32: the follower led before the kill")

            sent = {}

            def submit():
                _bulk_create(admin, "pods", flood, 0, _default_pod,
                             {"podNamePrefix": "pod-"})
                sent["t"] = time.monotonic()
            t_flood = time.monotonic()
            submitter = threading.Thread(target=submit, daemon=True)
            submitter.start()
            watch.wait_bound(kill_at, "default/pod-", "before the kill",
                             alive)
            killed.add(leader)
            leader.proc.kill()
            t_kill = time.monotonic()
            bound_at_kill = watch.bound("default/pod-")
            leader.proc.wait()
            leader._reader.join(timeout=5)
            print(f"   SIGKILL binary {lead_tag} at {bound_at_kill} flood "
                  f"pods bound, {t_kill - t_flood:.3f} s into the flood",
                  flush=True)
            # the leader's counts as of the last batch it retired
            last = leader.last(re.escape(CHILD_BATCH_TAG) + "(.*)")
            check(last is not None, "32: the leader printed no batch count")
            led_got = json.loads(last[1][1])
            t_led, hit = follower.wait_line(
                r"(kube-scheduler-[0-9a-f]+) became leader",
                "the follower's takeover", timeout=BINARY_STEP_S)
            ident[follow_tag] = hit[1]
            t_end = watch.wait_bound(flood, "default/pod-", "the flood",
                                     alive)
            submitter.join(timeout=BINARY_STEP_S)
            check("t" in sent, "32: the flood's submitter did not finish")
            lease = admin.get("leases", "kube-system", "kube-scheduler")
            check(lease["spec"]["holderIdentity"] == ident[follow_tag],
                  f"32: after the takeover the Lease is held by "
                  f"{lease['spec']['holderIdentity']}")
            flood_keys = [k for k in watch.bound_at
                          if k.startswith("default/pod-")]
            after = sorted(watch.bound_at[k] for k in flood_keys
                           if watch.bound_at[k] >= t_led)
            check(after, "32: the survivor bound no pod")
            t_first = after[0]
            # exactly once, never moved, within caps
            check(not watch.changed, f"32: nodeName changed: "
                                     f"{watch.changed[:5]}")
            check(len(watch.binds) == warm + flood
                  and set(watch.binds.values()) == {1},
                  f"32: {len(watch.binds)} pods bound, bind counts "
                  f"{sorted(set(watch.binds.values()))}")
            used = check_binary_caps(admin, warm + flood, "32")
            time.sleep(1.0)
            torch_mib["survivor"] = check_in_sync(
                follower, f"binary {follow_tag} (the survivor)")
            used1, apps1 = device_memory()

            alive()
            since = len(follower.lines)
            killed.update(children)   # from here on exits are expected
            follower.proc.send_signal(signal.SIGTERM)
            t_term = time.monotonic()
            try:
                rc = follower.proc.wait(timeout=BINARY_TERM_S)
            except subprocess.TimeoutExpired:
                raise SystemExit(f"CHECK FAILED: 32: the survivor outlived "
                                 f"SIGTERM by {BINARY_TERM_S} s") from None
            term_s = time.monotonic() - t_term
            follower._reader.join(timeout=5)
            check(rc == 0, f"32: the survivor exited {rc}")
            _t, hit = follower.wait_line(re.escape(CHILD_TAG) + "(.*)",
                                         "its launch count", since)
            got = json.loads(hit[1])

            lat = sorted((watch.bound_at[k] - watch.added[k]) * 1e3
                         for k in flood_keys)
            p50 = lat[len(lat) // 2]
            p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
            before_rate = bound_at_kill / (t_kill - t_flood)
            after_rate = (flood - bound_at_kill) / (t_end - t_kill)
            taken_rate = len(after) / max(t_end - t_first, 1e-9)
            print(f"   flood: {flood} pods sent in "
                  f"{sent['t'] - t_flood:.3f} s; pods/s before the kill "
                  f"{before_rate:.1f}, after it {after_rate:.1f} (kill to "
                  f"the last bind, {t_end - t_kill:.3f} s), from the "
                  f"survivor's first bind {taken_rate:.1f} ({len(after)} "
                  f"pods in {t_end - t_first:.3f} s) [{smi}]", flush=True)
            print(f"   pod e2e (first seen to bound, the watch), flood: "
                  f"p50 {p50:.2f} ms p99 {p99:.2f} ms [{smi}]", flush=True)
            print(f"   takeover: kill to \"became leader\" "
                  f"{t_led - t_kill:.3f} s, to the survivor's first bind "
                  f"{t_first - t_kill:.3f} s ({t_first - t_led:.3f} s after "
                  f"leading) [{smi}]", flush=True)
            print(f"   device memory (nvidia-smi memory.used, MiB): "
                  f"{used0:.0f} before the binaries, {used2:.0f} with both "
                  f"warm, {used1:.0f} with the survivor alone after the "
                  f"flood: the leader {lead_tag} {used2 - used1:.0f}, the "
                  f"survivor {follow_tag} {used1 - used0:.0f}; compute "
                  f"apps (pid, MiB) {apps2!r} then {apps1!r}; torch "
                  f"allocator MiB {torch_mib} [{smi}]", flush=True)
            print(f"   survivor binary {follow_tag}: "
                  f"claims launches {got['launches']['claims']}, escapes "
                  f"{got['escaped']} {got['by_reason']}, batches "
                  f"{got['batches']} (plain {got['plain']}, waves "
                  f"{got['waves']}) on {got.get('device')}; SIGTERM to exit "
                  f"{term_s:.3f} s; pods on {used} nodes [{smi}]", flush=True)
            check(got["launches"]["claims"] > 0,
                  "32: the survivor never launched the claims kernel")
            check(got["escaped"] == 0 and not got["by_reason"],
                  f"32: the survivor sent pods to the per-pod path: {got}")
            check(got["plain"] == got["batches"] > 0,
                  f"32: the survivor's batches: {got}")
            print(f"   killed leader binary {lead_tag}, as of its last "
                  f"retired batch: claims launches "
                  f"{led_got['launches']['claims']}, escapes "
                  f"{led_got['escaped']} {led_got['by_reason']}, batches "
                  f"{led_got['batches']} (plain {led_got['plain']}, waves "
                  f"{led_got['waves']}) on {led_got.get('device')} [{smi}]",
                  flush=True)
            check(led_got["launches"]["claims"] > 0,
                  "32: the leader never launched the claims kernel")
            check(led_got["escaped"] == 0 and not led_got["by_reason"],
                  f"32: the leader sent pods to the per-pod path: "
                  f"{led_got}")
            check(led_got["plain"] == led_got["batches"] > 0,
                  f"32: the leader's batches: {led_got}")
            api.proc.send_signal(signal.SIGTERM)
            check(api.proc.wait(timeout=30) == 0,
                  f"32: the apiserver exited {api.proc.returncode}")
            return led_got["launches"]["claims"] + got["launches"]["claims"]
        finally:
            if watch is not None:
                watch.close()
            for child in reversed(children):
                child.stop()



# phase 33(i): perf.bench.run_scaleout_proc(PROC_MAX) on the card, N = 1
# and 2.  perf.bench --processes 4 runs 1, 2 and 4; with N=4 on the card
# phase 33 took 247.8 s on an H100 80GB HBM3 at 700 W, which beside phases
# 1-32 (731-801 s there) leaves too little of the script's 1,200 s limit,
# so N=4 stays on the null device's row
PROC_MAX = 2
PROC_RECORDS = 2          # 33(iii): child 1 of this count records a wave
PROC_TIMEOUT = 180.0      # every barrier of phase 33, s
PROC_DRAIN_S = 120.0      # SIGTERM to exit, the recording child's check in it
PROC_ROLL_WARM = 2000     # 33(ii): pods bound before the roll
PROC_ROLL_PODS = 6000     # ... and during it, in chunks of 1,000
PROC_ROLL_GAP_S = 2.0     # between two chunks
PROC_TAG = "proc-child: "
PROC_BATCH_TAG = "proc-child batch: "
PROC_WAVE_TAG = "proc-child wave: "
PROC_RECORD_ENV = "KTPU_SMOKE_RECORD_WAVE"


def proc_child(argv):
    """--proc-child ARGS: the process supervisor's scheduler child
    (kubernetes_tpu_torch.scheduler.procrun.main(["--child", *ARGS]),
    unchanged), instrumented by instrument_child: its counts after every
    batch (PROC_BATCH_TAG) and, once the child returns (its drain), after
    PROC_TAG.  With KTPU_SMOKE_RECORD_WAVE=1 it keeps the inputs of its
    first claims launch with a live pod after the warmup, and once the
    child returns holds the kernel against its plain version on them
    (check_claims: murmur exact, sin within 1e-4 at a feasible choice),
    times both and prints PROC_WAVE_TAG and a JSON object (shape, live
    pods, noise, max |best err|, ms, plain ms, bound ms and what bounds
    it)."""
    from kubernetes_tpu_torch.scheduler import procrun

    record = os.environ.get(PROC_RECORD_ENV) == "1"
    counts, finish, rec = instrument_child(PROC_BATCH_TAG, record)
    with rec:
        try:
            procrun.main(["--child", *argv])
            rc = 0
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
            if not isinstance(e.code, int):
                print(e.code, file=sys.stderr, flush=True)
    finish()
    print(PROC_TAG + json.dumps(counts()), flush=True)
    if record and "wave" in rec.kept:
        print(PROC_WAVE_TAG + json.dumps(recorded_wave(rec, "33(iii)")),
              flush=True)
    return rc


def recorded_wave(rec, label):
    """The claims kernel held against its plain version on the wave a
    child's ClaimsRecorder kept (check_claims: murmur exact, sin within
    1e-4 at a feasible choice), both timed: shape, live pods, noise, max
    |best err|, ms, plain ms, bound ms and what bounds it."""
    from kubernetes_tpu_torch.ops import kernels
    *wave, noise, pod_ids = rec.kept.pop("wave")
    args = tuple(wave)
    P, N, _R = args[0]["shape"]
    err, *answer = check_claims(kernels, args, noise,
                                f"{label} child wave {P}x{N}", pod_ids)
    ms = time_cuda(lambda: kernels.claims(
        *args, noise=noise, pod_ids=pod_ids), 20)
    plain_ms = time_cuda(lambda: kernels.claims_reference(
        *args, noise=noise, pod_ids=pod_ids), 3, warmup=1)
    b = claims_bounds(args, noise, answer)
    return {"shape": [P, N], "live": int(args[1].sum()), "noise": noise,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["required"][0], "bound_by": b["required"][1]}


def smoke_proc_cluster():
    """procrun.ProcCluster whose children are this script's --proc-child
    entry, keeping every child it ever spawned (a respawn replaces the
    supervisor's own record of an index)."""
    from kubernetes_tpu_torch.scheduler.procrun import ProcCluster

    class SmokeProcCluster(ProcCluster):
        child_entry = (str(Path(__file__).resolve()), "--proc-child")

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.spawned = []

        def _spawn(self, index):
            child = super()._spawn(index)
            self.spawned.append(child)
            return child
    return SmokeProcCluster


def child_json(child, tag, timeout=10.0):
    """The last line of a procrun child that starts with `tag`, decoded
    (its output is read by a thread: give it `timeout` s to arrive)."""
    deadline = time.monotonic() + timeout
    while True:
        for line in reversed(child.tail(200)):
            if line.startswith(tag):
                return json.loads(line[len(tag):])
        if time.monotonic() > deadline:
            return None
        time.sleep(0.05)


def drain_children(cluster, label, timeout=PROC_DRAIN_S):
    """SIGTERM every live child and wait for each to exit 0."""
    for i in cluster.live_indices():
        rc = cluster.drain(i, timeout=timeout)
        check(rc == 0, f"{label}: child {i} drained with {rc}; its last "
                       f"lines {cluster._children[i].tail(12)}")


def check_children(children, label, smi, killed=()):
    """Every child that ran batches launched the claims kernel, sent no
    pod to the per-pod path and ran plain batches only, on the card; a
    child in `killed` is read from its last batch line.  Returns the
    claims launches of all of them."""
    total = 0
    for n, child in enumerate(children):
        tag = PROC_BATCH_TAG if child in killed else PROC_TAG
        got = child_json(child, tag)
        what = (f"{label} child {child.index} (spawn {n}, pid "
                f"{child.proc.pid}{', killed' if child in killed else ''})")
        check(got is not None, f"{what}: no counts; its last lines "
                               f"{child.tail(12)}")
        print(f"   {what}: claims launches {got['launches']['claims']}, "
              f"batches {got['batches']} (plain {got['plain']}, waves "
              f"{got['waves']}), escapes {got['escaped']} "
              f"{got['by_reason']} on {got.get('device')}; torch allocator "
              f"reserved {got.get('reserved_mib', 0):.0f} MiB, peak "
              f"{got.get('peak_reserved_mib', 0):.0f} [{smi}]", flush=True)
        if got["batches"]:
            check(got.get("device", "").startswith("cuda"),
                  f"{what}: its backend ran on {got.get('device')}")
            check(got["launches"]["claims"] > 0,
                  f"{what}: bound pods and never launched the claims kernel")
            check(got["plain"] == got["batches"],
                  f"{what}: batches {got['batches']} plain {got['plain']}")
        check(got["escaped"] == 0 and not got["by_reason"],
              f"{what}: sent pods to the per-pod path: {got}")
        total += got["launches"]["claims"]
    return total


def idle_shares(cluster):
    """Each child's wave-timeline idle share, as the supervisor federates
    it (scheduler_proc_wave_device_idle_share)."""
    out = {}
    for line in cluster.supervisor_metrics_text().splitlines():
        hit = re.match(r'scheduler_proc_wave_device_idle_share'
                       r'\{instance="(\d+)"\} (\S+)', line)
        if hit:
            out[int(hit[1])] = round(float(hit[2]), 4)
    return out


def proc_scaleout(smi, cls, nodes, pods, batch, device):
    """33(i): perf.bench.run_scaleout_proc(PROC_MAX) at the row's shape
    with every child a TorchBatchBackend on the card (backend "tpu"), the
    timeline armed in each (KTPU_PROC_TIMELINE=1) and child 1 of the N=2
    pass recording its first wave (33(iii)).  Returns (claims launches,
    the recorded wave's line)."""
    from kubernetes_tpu_torch.perf import bench
    seen, wave = {"launches": 0}, {}

    def before(n):
        seen[n] = {"used0": device_memory()[0]}

    def flooded(n, row, cluster):
        used, apps = device_memory()
        seen[n].update(used=used, apps=apps, idle=idle_shares(cluster))
        label = f"33(i) N={n}"
        print(f"   {label}: {row['pods_per_s']} pods/s, flood wall "
              f"{row['wall_s']} s, bound {row['bound']}, double binds "
              f"{row['double_binds']}; conflicts {row['conflicts']} (rate "
              f"{row['conflict_rate']}); device memory (nvidia-smi "
              f"memory.used) {seen[n]['used0']:.0f} MiB before the "
              f"children, {used:.0f} with them: "
              f"{(used - seen[n]['used0']) / n:.0f} MiB a child; compute "
              f"apps {apps!r}; the timeline's idle share per child "
              f"{seen[n]['idle']} [{smi}]", flush=True)
        check("error" not in row, f"{label}: {row.get('error')}")
        check(row["bound"] == pods and row["double_binds"] == 0,
              f"{label}: bound {row['bound']}, double binds "
              f"{row['double_binds']}")
        check(len(seen[n]["idle"]) == n,
              f"{label}: idle shares of {sorted(seen[n]['idle'])}")

    def after(n, row, cluster):
        label = f"33(i) N={n}"
        want = pods
        churn = row.get("churn")
        if churn is not None:
            print(f"   {label} crash sub-pass: {churn} [{smi}]", flush=True)
            check(churn["applied"] == ["kill_instance", 0]
                  and churn["zero_lost"] and churn["double_binds"] == 0,
                  f"{label}: the crash sub-pass {churn}")
            want += churn["extra_pods"]
            check(churn["bound_after"] == want,
                  f"{label}: {churn['bound_after']} of {want} bound")
        used = check_binary_caps(cluster.admin_client(), want, label)
        print(f"   {label}: every one of {want} pods bound once within "
              f"caps, on {used} nodes", flush=True)
        children = cluster.spawned
        if n == PROC_RECORDS:   # child 1 checks its recorded wave as it exits
            rc = cluster.drain(1, timeout=PROC_DRAIN_S)
            check(rc == 0, f"{label}: the recording child exited {rc}")
            got = child_json(children[1], PROC_WAVE_TAG)
            check(got is not None, f"{label}: child 1 printed no recorded "
                                   f"wave; its last lines "
                                   f"{children[1].tail(12)}")
            wave.update(got)
            print(f"   33(iii) N={n} child 1's first wave {got['shape']} "
                  f"({got['live']} live pods, {got['noise']}) in its own "
                  f"process: max |best err| {got['max_abs_err']}, "
                  f"{got['ms']:.4f} ms/launch, plain version "
                  f"{got['plain_ms']:.4f} ms, bound {got['bound_ms']:.4f} ms "
                  f"({got['bound_by']}) [{smi}]", flush=True)
        drain_children(cluster, label)
        killed = [children[0]] if churn is not None else []
        seen["launches"] += check_children(children, label, smi, killed)
        check(cluster.drain_escalations == 0,
              f"{label}: {cluster.drain_escalations} drains escalated")

    res = bench.run_scaleout_proc(
        PROC_MAX, nodes=nodes, pods=pods, batch=batch,
        timeout=PROC_TIMEOUT, backend="tpu", device=device,
        cluster_cls=cls,
        child_env={i: {"KTPU_PROC_TIMELINE": "1",
                       **({PROC_RECORD_ENV: "1"} if i == 1 else {})}
                   for i in range(PROC_MAX)},
        before=before, flooded=flooded, after=after)
    rows = res["BENCH_SCALEOUT_PROC"]
    print("   33(i) speedup_vs_1: " + ", ".join(
        f"N={n} {row.get('speedup_vs_1')}" for n, row in rows.items())
        + f" (host cores {res['host_cores']}) [{smi}]", flush=True)
    check(wave, "33(iii): no recorded wave")
    return seen["launches"], wave


def proc_roll(smi, cls, nodes, batch, device):
    """33(ii): a rolling upgrade of two children on the card while pods
    arrive: UpgradeDriver(UpgradeSchedule(seed=17, script={1: (roll,
    1, sabotaged)})).roll_all() over a ProcCluster with a warm-start
    directory; roll 0 drains child 0 (its mirror checkpointed) and
    respawns it warm, roll 1 SIGKILLs child 1 mid-drain and respawns it
    cold.  PROC_ROLL_WARM pods bound first, PROC_ROLL_PODS more in
    chunks of 1,000 during the roll.  The roll has a cluster of its own:
    on the N=2 pass's cluster every respawn lists that pass's 63,000
    pods, and the roll took 39.3 s there against 17.1-30.0 s on a
    cluster of its own, on an H100 80GB HBM3 at 700 W (PERF.md §6).
    Returns the claims launches."""
    import tempfile

    from kubernetes_tpu_torch.ops.faults import (
        ROLL_INSTANCE, UpgradeDriver, UpgradeSchedule,
    )
    from kubernetes_tpu_torch.perf import bench
    from kubernetes_tpu_torch.scheduler.procrun import WireBindLedger
    from kubernetes_tpu_torch.testing import make_node
    label = "33(ii) roll"
    total = PROC_ROLL_WARM + PROC_ROLL_PODS
    with tempfile.TemporaryDirectory(prefix="phase33-") as warm:
        cluster = cls(2, backend="tpu", batch_size=batch, nodes=nodes,
                      warm_dir=warm, ready_timeout=PROC_TIMEOUT,
                      device=device)
        try:
            cluster.start()
            admin = cluster.admin_client()
            for lo in range(0, nodes, bench.SCALEOUT_CHUNK):
                admin.create_bulk("nodes", [
                    make_node(f"sn-{i}")
                    .capacity(cpu="64", mem="256Gi", pods=1000).build()
                    for i in range(lo, min(lo + bench.SCALEOUT_CHUNK,
                                           nodes))])
            time.sleep(2.0 + nodes / 20_000)
            ledger = WireBindLedger(admin)
            bench.create_flood_pods(admin, 0, PROC_ROLL_WARM)
            check(bench.await_bound(ledger, PROC_ROLL_WARM, PROC_TIMEOUT),
                  f"{label}: {ledger.bound_total()} of {PROC_ROLL_WARM} "
                  f"warm-up pods bound")
            sent = []

            def submit():
                for lo in range(PROC_ROLL_WARM, total, 1000):
                    bench.create_flood_pods(admin, lo, lo + 1000)
                    sent.append(time.monotonic())
                    time.sleep(PROC_ROLL_GAP_S)
            submitter = threading.Thread(target=submit, daemon=True)
            upgrader = UpgradeDriver(cluster, UpgradeSchedule(
                seed=17, instance_count=2,
                script={1: (ROLL_INSTANCE, 1, True)}),
                drain_timeout=PROC_DRAIN_S, ready_timeout=PROC_TIMEOUT)
            t0 = time.monotonic()
            submitter.start()
            rolled = upgrader.roll_all()
            roll_s = time.monotonic() - t0
            submitter.join(timeout=PROC_TIMEOUT)
            check(len(sent) == PROC_ROLL_PODS // 1000,
                  f"{label}: {len(sent)} chunks sent")
            ok = bench.await_bound(ledger, total, PROC_TIMEOUT)
            bound_s = time.monotonic() - t0
            check(ok, f"{label}: {ledger.bound_total()} of {total} bound")
            try:
                ledger.assert_no_double_binds()
            except AssertionError as e:
                raise SystemExit(f"CHECK FAILED: {label}: {e}") from None
            check(ledger.bound_total() == total,
                  f"{label}: {ledger.bound_total()} of {total} bound")
            ledger.stop()
            check_binary_caps(admin, total, label)
            check(rolled == [(ROLL_INSTANCE, 0), (ROLL_INSTANCE, 1)]
                  and upgrader.injected["sabotaged"] == 1,
                  f"{label}: rolled {rolled}, {upgrader.injected}")
            check(cluster.drain_escalations == 1,
                  f"{label}: {cluster.drain_escalations} drains escalated")
            first0, first1, again0, again1 = cluster.spawned
            cut = [line for line in first0.tail(200)
                   if "checkpointed" in line]
            warm_rows = [int(hit[1]) for line in again0.tail(200)
                         for hit in [re.search(r"warm start: (\d+) rows",
                                               line)] if hit]
            print(f"   {label}: rolled {rolled} in {roll_s:.3f} s, "
                  f"{total} pods bound exactly once within caps "
                  f"{bound_s:.3f} s after the roll began; drain "
                  f"escalations {cluster.drain_escalations}; child 0's "
                  f"drain: {cut[-1:]}; its respawn: warm start of "
                  f"{warm_rows} rows; child 1's respawn: warm start lines "
                  f"{[ln for ln in again1.tail(200) if 'warm start' in ln]}"
                  f" [{smi}]", flush=True)
            check(warm_rows and warm_rows[0] > 0,
                  f"{label}: the respawned clean child did not warm-start; "
                  f"its lines {again0.tail(12)}")
            check(not any("warm start" in line for line in again1.tail(200)),
                  f"{label}: the escalated child did not start cold")
            drain_children(cluster, label)
            return check_children(cluster.spawned, label, smi,
                                  killed=[first1])
        finally:
            cluster.shutdown()


def proc_phase(smi, nodes=20_000, pods=60_000, batch=4096, device=None):
    """Phase 33: process-true scale-out on the card (scheduler/procrun.py):
    (i) an apiserver process and N = 1, 2 (PROC_MAX) scheduler
    processes, each a TorchBatchBackend on the card, at perf.bench
    --processes' shape (20,000 nodes of 64 CPU / 256Gi / 1,000 pods,
    60,000 pods of 10m / 16Mi in chunks of 10,000, batch 4,096), the
    seeded crash sub-pass at N > 1; (ii) a rolling upgrade of two
    children with a warm-start directory, the second roll sabotaged,
    while 6,000 pods arrive; (iii) child 1 of the N=2 pass holds its
    first recorded wave against the plain version in its own process.
    Every pass: every pod bound exactly once within caps, every child
    that ran batches launched the claims kernel with 0 escapes.  `device`
    is the children's --device (None: their default, CUDA).  Returns
    (claims launches of every child, the recorded wave's max |best
    err|)."""
    cls = smoke_proc_cluster()
    with Phase("33 process-true scale-out on the card"):
        launches, wave = proc_scaleout(smi, cls, nodes, pods, batch, device)
        launches += proc_roll(smi, cls, nodes, batch, device)
        print(f"   33: claims launches in the children {launches} [{smi}]",
              flush=True)
    return launches, wave["max_abs_err"]


# phase 34: store replication (store/replica.py) under the port's scheduler
REPLICA_NODES = 5000       # SchedulingBasicHTTP's cluster (bench.py:127-140)
REPLICA_WARM = 1000        # warm-up pods, bound before the flood
REPLICA_FLOOD = 10_000     # the flood, created in one bulk write
REPLICA_FREEZE_AT = 3000   # the partition once this many flood binds acked
REPLICA_BATCH = 4096
REPLICA_SYNC_S = 2.0       # the hub's sync_timeout
REPLICA_GRACE_S = 5.0      # the follower's auto_promote_after: > sync_timeout
REPLICA_STEP_S = 120.0     # every wait of phase 34, s


class BlackholeProxy:
    """A TCP forwarder between a follower and its hub that can go silent
    both ways (freeze()) without closing either socket: a network
    partition, not a clean FIN (tests/test_store_replica.py's
    _BlackholeProxy, with close())."""

    def __init__(self, target_host, target_port):
        self._target = (target_host, target_port)
        self._ls = socket.socket()
        self._ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._ls.bind(("127.0.0.1", 0))
        self._ls.listen(1)
        self.address = self._ls.getsockname()
        self.frozen = threading.Event()
        self._socks = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        try:
            a, _ = self._ls.accept()
            b = socket.create_connection(self._target)
            self._socks = [a, b]
            for src, dst in ((a, b), (b, a)):
                threading.Thread(target=self._pump, args=(src, dst),
                                 daemon=True).start()
        except OSError:
            pass

    def _pump(self, src, dst):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    return
                if self.frozen.is_set():
                    continue  # swallowed: the partition never heals
                dst.sendall(data)
        except OSError:
            pass

    def freeze(self):
        self.frozen.set()

    def close(self):
        for s in [self._ls, *self._socks]:
            try:
                s.close()
            except OSError:
                pass


def replica_failover(nodes=REPLICA_NODES, warm=REPLICA_WARM,
                     flood=REPLICA_FLOOD, freeze_at=REPLICA_FREEZE_AT,
                     batch=REPLICA_BATCH, device=None,
                     sync_timeout=REPLICA_SYNC_S, grace=REPLICA_GRACE_S,
                     on_b_done=None):
    """Phase 34's run, the card's or the CPU's (`device`: the backends';
    None is CUDA).  The primary is a promoted FollowerStore with a
    ReplicationHub(sync=True, fencing=True, sync_timeout, heartbeat
    0.1 s); the follower follows through a BlackholeProxy and runs
    auto_promote_after(grace).  Scheduler A (setup_cluster over the
    primary, a TorchBatchBackend, depth 2) binds `warm` pods on `nodes`
    nodes of SchedulingBasicHTTP's shape, then a flood of `flood` pods
    made in one bulk write.  Right after the bind_many call that brings
    A's acknowledged flood binds to `freeze_at` returns, the proxy
    freezes; A's next commit fences the primary and its bind wave
    requeues; A stops once bind_many has raised FencedError to it (its
    in-flight batches retire in stop()).  The follower promotes itself;
    scheduler B, over the promoted store, relists and binds the rest.
    Then the deposed primary rejoins as the follower of a hub on the
    promoted store.

    Checked here (check() fails the run): every bind A saw acknowledged
    (bind_many returned it without an error) stands on the promoted store
    on the same node; A counted no pod as scheduled that it did not see
    acknowledged; every pod is bound exactly once (a watch on the
    follower from its first snapshot on) within its node's caps; the
    epoch rose by one; after the rejoin the deposed primary's pods table
    equals the promoted store's; each scheduler's backend is a
    TorchBatchBackend on `device` whose batches were all plain, and no
    pod escaped to the per-pod path.  The claims launches of A (counted
    from the end of its backend's warmup to its stop) and of B (from the
    end of its backend's warmup to its stop), and the inputs of B's first
    claims launch with a live pod, are returned for the caller to check.
    `on_b_done()` runs once B has bound every pod, before B stops."""
    from kubernetes_tpu_torch.client import LocalClient
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        _bulk_create, _default_node, _default_pod, setup_cluster)
    from kubernetes_tpu_torch.store import kv
    from kubernetes_tpu_torch.store.replica import (
        FollowerStore, ReplicationHub)

    dev_type = torch.device(device or "cuda").type
    caps = caps_for_nodes(nodes)
    # what A saw acknowledged (key -> node), and when each step came
    st = {"acked": {}, "flood_acked": 0, "a_fenced": threading.Event(),
          "b_first": None, "t_freeze": None, "t_fenced": None,
          "frozen_at": None, "t_store_fenced": None, "t_promoted": None}
    primary = FollowerStore(history=1_000_000).promote()
    hub = ReplicationHub(primary, sync=True, fencing=True,
                         sync_timeout=sync_timeout,
                         heartbeat_interval=0.1).start()
    proxy = BlackholeProxy(*hub.address)
    follower = FollowerStore(history=1_000_000)
    follower.follow(*proxy.address)
    follower.auto_promote_after(grace)
    fence = primary.fence

    def stamped_fence(reason):
        if st["t_store_fenced"] is None:
            st["t_store_fenced"] = time.monotonic()
        fence(reason)
    primary.fence = stamped_fence

    def stamp_promotion():
        if follower.promoted_event.wait(REPLICA_STEP_S * 2):
            st["t_promoted"] = time.monotonic()
    threading.Thread(target=stamp_promotion, daemon=True).start()
    follower_client = LocalClient(follower)
    watch = BindWatch(follower_client)
    bind_many, warmup = LocalClient.bind_many, TorchBatchBackend.warmup
    sides = {id(primary): "A", id(follower): "B"}
    launches, arm = {}, {"tag": None}
    rec = ClaimsRecorder(kernels, first_live=True)

    def counted_bind_many(client, bindings):
        side = sides.get(id(client.store))
        try:
            out = bind_many(client, bindings)
        except kv.FencedError:
            if side == "A" and st["t_fenced"] is None:
                st["t_fenced"] = time.monotonic()
                st["a_fenced"].set()
            raise
        now = time.monotonic()
        if side == "A":
            for entry, (_obj, err) in zip(bindings, out):
                if err is None:
                    key = f"{entry[0]}/{entry[1]}"
                    st["acked"][key] = entry[2]
                    st["flood_acked"] += key.startswith("default/pod-")
            if st["t_freeze"] is None and st["flood_acked"] >= freeze_at:
                proxy.freeze()
                st["t_freeze"], st["frozen_at"] = now, st["flood_acked"]
        elif side == "B" and st["b_first"] is None and any(
                err is None for _obj, err in out):
            st["b_first"] = now
        return out

    def warm_then_zero(backend):
        warmup(backend)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        rec.armed = arm["tag"]

    def wait(pred, what):
        deadline = time.monotonic() + REPLICA_STEP_S
        while not pred():
            check(watch.error is None,
                  f"34: the follower's pods watch failed: "
                  f"{watch.error}")
            check(time.monotonic() < deadline,
                  f"34: {what} not within {REPLICA_STEP_S} s")
            time.sleep(0.005)
        return time.monotonic()

    def pods_by_key(store):
        items, _ = store.list("pods")
        return {f"{o['metadata']['namespace']}/{o['metadata']['name']}": o
                for o in items}

    def pod_nodes(store):
        return {k: (o.get("spec") or {}).get("nodeName")
                for k, o in pods_by_key(store).items()}

    cl_a = cl_b = hub2 = None
    stopped = set()
    LocalClient.bind_many = counted_bind_many
    TorchBatchBackend.warmup = warm_then_zero
    try:
        with rec:
            t0 = time.monotonic()
            cl_a = setup_cluster(caps=caps, batch_size=batch, store=primary,
                                 pipeline_depth=2, device=device)
            _bulk_create(cl_a.client, "nodes", nodes, 0, _default_node, {})
            _bulk_create(cl_a.client, "pods", warm, 0, _default_pod,
                         {"podNamePrefix": "warm-"})
            wait(lambda: watch.bound("default/warm-") >= warm,
                 f"A's {warm} warm-up binds")
            t_warm = time.monotonic()
            params = {"podNamePrefix": "pod-"}
            pods = [_default_pod(i, params) for i in range(flood)]
            t_flood = time.monotonic()
            cl_a.client.create_bulk("pods", pods)   # one commit, one frame
            del pods
            t_sent = time.monotonic()
            wait(st["a_fenced"].is_set, "A's first FencedError from "
                                        "bind_many")
            check(st["t_freeze"] is not None,
                  "34: A was fenced before the partition")
            t_a = time.monotonic()
            cl_a.shutdown()
            stopped.add("A")
            a_stop_s = time.monotonic() - t_a
            sched_a = cl_a.scheduler
            launches["A"] = kernels.LAUNCHES["claims"]
            batches_a = check_instances([cl_a], "34 A",
                                        device_type=dev_type)
            fenced_a = conflict_counts([cl_a])
            with sched_a.metrics.lock:
                scheduled_a = sched_a.metrics.schedule_attempts["scheduled"]
            check(scheduled_a == len(st["acked"]),
                  f"34: A counted {scheduled_a} pods scheduled, "
                  f"{len(st['acked'])} binds acknowledged")
            check(fenced_a["fenced"] > 0,
                  f"34: A requeued no pod as fenced: {fenced_a}")
            wait(lambda: st["t_promoted"] is not None,
                 "the follower's promotion")
            check(follower.epoch == primary.epoch + 1,
                  f"34: epoch {primary.epoch} -> {follower.epoch}")
            old, new = pod_nodes(primary), pod_nodes(follower)
            dirty = sorted(k for k, node in old.items()
                           if node and new.get(k) != node)
            lost = sorted(k for k, node in st["acked"].items()
                          if new.get(k) != node)
            check(not lost, f"34: {len(lost)} acknowledged binds are "
                            f"not on the promoted store as acked: "
                            f"{lost[:5]}")
            b_bound = sum(1 for node in new.values() if not node)
            arm["tag"] = "B"
            t_b = time.monotonic()
            cl_b = setup_cluster(caps=caps, batch_size=batch,
                                 store=follower, pipeline_depth=2,
                                 device=device)
            t_b_up = time.monotonic()
            t_end = wait(lambda: watch.bound("default/") >= warm + flood,
                         f"all {warm + flood} pods bound")
            if on_b_done is not None:
                on_b_done()
            t_b_stop = time.monotonic()
            cl_b.shutdown()
            stopped.add("B")
            b_stop_s = time.monotonic() - t_b_stop
            launches["B"] = kernels.LAUNCHES["claims"]
            batches_b = check_instances([cl_b], "34 B",
                                        device_type=dev_type)
        t_checks = time.monotonic()
        check(watch.error is None, f"34: the watch: {watch.error}")
        check(not watch.changed, f"34: nodeName changed: "
                                 f"{watch.changed[:5]}")
        check(len(watch.binds) == warm + flood
              and set(watch.binds.values()) == {1},
              f"34: {len(watch.binds)} pods bound, bind counts "
              f"{sorted(set(watch.binds.values()))}")
        used = check_binary_caps(follower_client, warm + flood, "34")
        checks_s = time.monotonic() - t_checks
        # the rejoin: the deposed primary follows a hub on the new one
        hub.stop()
        hub2 = ReplicationHub(follower, sync=True,
                              heartbeat_interval=0.1).start()
        t_r = time.monotonic()
        primary.rejoin(*hub2.address)
        rejoin_s = time.monotonic() - t_r
        t_cmp = time.monotonic()
        # as the wire carries them: the rejoined table is decoded JSON
        same = json.dumps(pods_by_key(primary), sort_keys=True) == \
            json.dumps(pods_by_key(follower), sort_keys=True)
        check(same, "34: after the rejoin the deposed primary's pods "
                    "differ from the promoted store's")
        return {
            "a_stop_s": a_stop_s, "b_stop_s": b_stop_s,
            "checks_s": checks_s, "compare_s": time.monotonic() - t_cmp,
            "acked": len(st["acked"]), "frozen_at": st["frozen_at"],
            "dirty": len(dirty), "launches": launches,
            "wave": rec.kept.get("B"), "batches": (batches_a, batches_b),
            "fenced": fenced_a, "nodes_used": used,
            "epochs": (primary.epoch, follower.epoch),
            "setup_s": t_warm - t0, "sent_s": t_sent - t_flood,
            "rate_before": st["frozen_at"] / (st["t_freeze"] - t_flood),
            "to_store_fenced": st["t_store_fenced"] - st["t_freeze"],
            "to_fenced": st["t_fenced"] - st["t_freeze"],
            "to_promoted": st["t_promoted"] - st["t_freeze"],
            "to_b_first": st["b_first"] - st["t_freeze"],
            "b_setup_s": t_b_up - t_b, "b_bound": b_bound,
            "b_rate": b_bound / max(t_end - st["b_first"], 1e-9),
            "rejoin_s": rejoin_s}
    finally:
        LocalClient.bind_many, TorchBatchBackend.warmup = bind_many, warmup
        for tag, cl in (("A", cl_a), ("B", cl_b)):
            if cl is not None and tag not in stopped:
                cl.shutdown()
        for h in (hub, hub2):
            if h is not None:
                h.stop()
        proxy.close()
        watch.close()
        follower_client.close()


def replica_phase(smi, **kw):
    """Phase 34: store failover on the card.  replica_failover at its
    defaults (5,000 nodes of SchedulingBasicHTTP's shape, 1,000 warm-up
    pods, a flood of 10,000, batch 4,096, depth 2, the partition at
    3,000 acknowledged flood binds, sync_timeout 2 s, grace 5 s), both
    schedulers' backends on the card, and on top of its checks: A and B
    each launched the claims kernel, and B's first claims launch with a
    live pod replays equal to kernels.claims_reference under phase 5's
    rule (check_claims).  Prints pods/s before the partition beside phase
    30(iii)'s LocalClient number of this run, the times from the freeze
    to A's first FencedError, to the promotion and to B's first bind, A's
    acknowledged binds and the fenced primary's dirty tail, and the
    memory the card used.  Returns (claims launches of A and B, the
    recorded wave's max |best err|)."""
    from kubernetes_tpu_torch.ops import kernels
    with Phase("34 store failover on the card"):
        # no gc.collect() here: after phases 1-33 a full collection walks
        # every object they left, for seconds; the peak is read over what
        # was allocated when the phase began
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mem = {}

        def on_b_done():
            torch.cuda.synchronize()
            mem["used"], mem["apps"] = device_memory()
        t0 = time.monotonic()
        got = replica_failover(on_b_done=on_b_done, **kw)
        run_s = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() - base
        n = got["launches"]
        check(n["A"] > 0, "34: scheduler A never launched the claims kernel")
        check(n["B"] > 0, "34: scheduler B never launched the claims kernel")
        check(got["wave"] is not None, "34: B recorded no claims wave")
        *wave, noise, pod_ids = got["wave"]
        live = int(wave[1].sum())
        err = check_claims(kernels, tuple(wave), noise,
                           f"34 B's first wave ({live} live pods)",
                           pod_ids)[0]
        ref = FRONT_DOOR_RATES.get("iii")
        print(f"   34: pods/s before the partition "
              f"{got['rate_before']:.1f} ({got['frozen_at']} flood binds "
              f"acknowledged, sync shipping to the follower); phase "
              f"30(iii)'s LocalClient pods/s in this run "
              f"{'not run' if ref is None else f'{ref:.1f}'} [{smi}]",
              flush=True)
        print(f"   34: from the freeze to the primary's fence "
              f"{got['to_store_fenced']:.3f} s, to A's first FencedError "
              f"{got['to_fenced']:.3f} s, to the promotion "
              f"{got['to_promoted']:.3f} s, to B's first bind "
              f"{got['to_b_first']:.3f} s (B's setup_cluster "
              f"{got['b_setup_s']:.3f} s); B bound {got['b_bound']} pods "
              f"at {got['b_rate']:.1f} pods/s from its first bind [{smi}]",
              flush=True)
        print(f"   34: A's acknowledged binds {got['acked']} (the warm-up's "
              f"and {got['frozen_at']} of the flood); the fenced primary's "
              f"dirty tail {got['dirty']} pods; A's conflict counts "
              f"{got['fenced']}; epoch {got['epochs'][0]} -> "
              f"{got['epochs'][1]}; the rejoin {got['rejoin_s']:.3f} s, "
              f"the deposed primary's pods equal to the promoted store's; "
              f"pods on {got['nodes_used']} nodes [{smi}]", flush=True)
        print(f"   34: claims launches A {n['A']}, B {n['B']}; batches / "
              f"waves A {got['batches'][0]}, B {got['batches'][1]}; setup "
              f"to the warm-up's last bind {got['setup_s']:.3f} s, the "
              f"flood's one bulk write {got['sent_s']:.3f} s [{smi}]",
              flush=True)
        print(f"   34: device memory: torch peak allocated over the phase's "
              f"start {peak / 2**30:.3f} GiB; nvidia-smi memory.used "
              f"{mem['used']:.0f} MiB with B's backend warm (the process's "
              f"whole use) [{smi}]", flush=True)
        print(f"   34: the run {run_s:.3f} s: A's stop {got['a_stop_s']:.3f} "
              f"s, B's stop {got['b_stop_s']:.3f} s, the binds' checks "
              f"{got['checks_s']:.3f} s, the rejoin {got['rejoin_s']:.3f} "
              f"s and its comparison {got['compare_s']:.3f} s [{smi}]",
              flush=True)
    return n["A"] + n["B"], err


# phase 35: the node agent on the card.  5,000 hollow nodes (phase 32's
# cluster) do not register within 60 s; at 1,000 and 2,000 no pod count of
# N/2 or more is Running within 60 s, 250 pods at 1,000 nodes take 27-34
# s, and the binary outlives SIGTERM by 10 s at every pod count tried
# (ROADMAP R14(f)); at 500 nodes and 250 pods the phase runs in 30 s
# (H100 80GB HBM3 at 700 W; PERF.md section 4)
KUBELET_NODES = 500       # hollow nodes in one kubelet binary
KUBELET_PODS = 250        # pods, created in one bulk write
KUBELET_STEP_S = 60.0     # every wait of phase 35, s
KUBELET_TERM_S = 10.0     # SIGTERM to exit, s
KUBELET_ADMIN = "phase35-admin"
KUBELET_SCHED = "phase35-scheduler"
KUBELET_FULL = "full-0"   # the full kubelet's node
KUBELET_RUN_S = "1.5"     # the crashing container's life, s


class PodWatch(BindWatch):
    """BindWatch plus each pod's status as the watch sees it: its latest
    status, the phases it went through, the first time it was Running
    with Ready=True and every container running (and on which node), the
    hostIPs each node's pods reported, and the sequence of container
    states of each pod."""

    phase = "35"
    step_s = KUBELET_STEP_S

    def __init__(self, client):
        self.status, self.ready_at, self.ready_node = {}, {}, {}
        self.host_ips, self.states, self.uid = {}, {}, {}
        self.phases = {}
        super().__init__(client)

    def _event(self, ev, now):
        key = super()._event(ev, now)
        st = ev.object.get("status") or {}
        self.uid[key] = ev.object["metadata"].get("uid")
        self.status[key] = st
        if st.get("phase"):
            self.phases.setdefault(key, set()).add(st["phase"])
        cs = st.get("containerStatuses") or []
        states = tuple(c.get("state") for c in cs)
        seen = self.states.setdefault(key, [])
        if states and (not seen or seen[-1] != states):
            seen.append(states)
        node = (ev.object.get("spec") or {}).get("nodeName")
        if node and st.get("hostIP"):
            self.host_ips.setdefault(node, set()).add(st["hostIP"])
        if pod_ready(st) and key not in self.ready_at:
            self.ready_at[key] = now
            self.ready_node[key] = node
        return key

    def ready(self, prefix=""):
        return sum(1 for k in list(self.ready_at) if k.startswith(prefix))


def pod_ready(status):
    """Running, Ready=True, and every container reported running."""
    cs = status.get("containerStatuses") or []
    return (status.get("phase") == "Running" and bool(cs)
            and all(c.get("state") == "CONTAINER_RUNNING" for c in cs)
            and any(c.get("type") == "Ready" and c.get("status") == "True"
                    for c in status.get("conditions") or ()))


def restored_status(status):
    """What a restarted full kubelet reports for a running pod it
    restored from its checkpoint (ROADMAP R14(d);
    tests/test_torch_kubelet.py pins it in both packages): Running,
    Ready=False, no containerStatuses."""
    return (status.get("phase") == "Running"
            and status.get("containerStatuses") == []
            and any(c.get("type") == "Ready" and c.get("status") == "False"
                    for c in status.get("conditions") or ()))


def process_cpu_s(pid):
    """User + system CPU seconds of a live process, from /proc."""
    fields = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def process_rss_mib(pid):
    """Resident memory of a live process (VmRSS, MiB) and its threads."""
    status = dict(line.split(":", 1) for line in
                  Path(f"/proc/{pid}/status").read_text().splitlines()
                  if ":" in line)
    return (int(status["VmRSS"].split()[0]) / 1024,
            int(status["Threads"]))


def lease_times(client):
    """Every node Lease's renewTime, by name."""
    from kubernetes_tpu_torch.kubelet.hollow import LEASE_NS
    items, _ = client.list("leases", LEASE_NS)
    return {o["metadata"]["name"]: (o.get("spec") or {}).get("renewTime")
            for o in items}


def full_pods():
    """Phase 35(ii)'s two pods, each selecting the full kubelet's node:
    one with a readiness probe, one whose container exits with code 1
    after KUBELET_RUN_S under restartPolicy Always.  The second has a
    liveness probe: in the reference's logic PLEG reports the pod Failed
    once its one container has exited, before any sync restarts it, and
    the liveness worker (which holds the pod as it was added) is the path
    that restarts the container, with its backoff (ROADMAP R14(e))."""
    from kubernetes_tpu_torch.testing import make_pod
    out = []
    for name in ("probed", "crashy"):
        pod = make_pod(name).req(cpu="100m", mem="128Mi").build()
        pod["spec"]["nodeSelector"] = {HOST: KUBELET_FULL}
        pod["spec"]["restartPolicy"] = "Always"
        if name == "probed":
            pod["spec"]["containers"][0]["readinessProbe"] = {
                "periodSeconds": 0.2}
        else:
            pod["spec"]["containers"][0]["livenessProbe"] = {
                "periodSeconds": 0.2}
            pod["metadata"]["annotations"] = {
                "hollow/run-seconds": KUBELET_RUN_S,
                "hollow/exit-code": "1"}
        out.append(pod)
    return out


def kubelet_run(smi, nodes=KUBELET_NODES, pods=KUBELET_PODS,
                batch=BINARY_BATCH, device="cuda"):
    """Phase 35's run: the node agent under the scheduler binary.  The
    port's apiserver runs as a process (RBAC, a token file, the default
    admission chain less the harness's list, a WAL); the port's
    scheduler binary runs behind it on
    the card (--tpu-batch --batch-size 4096 --node-capacity
    caps_for_nodes(nodes + 1).n_cap, under system:kube-scheduler's token,
    through this script's --binary-child entry, which counts its claims
    launches and escapes); and one kubelet binary,
    python -m kubernetes_tpu_torch.cmd.kubelet --hollow-nodes N, runs N
    hollow nodes.  The kubelet binary holds an admin token: one identity
    serves all N nodes, which the node authorizer (one identity a node)
    cannot allow.

    (i) The hollow flood: the N nodes register, each with its Lease in
    kube-node-lease; P pods are created in one bulk write; every pod must
    be bound exactly once within caps, never moved, and reach Running
    with Ready=True and its containerStatuses on the node it was bound
    to (each node's pods report one hostIP), as a watch sees it.  Every
    node's Lease renewTime must advance at least once (the hollow
    heartbeat is 10 s).
    (ii) The full kubelet: a second kubelet binary, --full --node-name
    full-0 --root-dir DIR; two pods select full-0 and the scheduler binds
    both on the card.  The probed pod must turn Ready.  The other's one
    container exits with code 1 every KUBELET_RUN_S: its pod must read
    Failed (ROADMAP R14(e)) and its liveness probe must have the
    container restarted with the crash backoff (the kubelet's log: 0.25
    s, then 0.5 s).  Once the checkpoint holds both pods the binary is
    SIGKILLed and restarted on the same root dir; a pod that was running
    must then read Running, Ready=False, no containerStatuses (R14(d)),
    and a terminal one keep its status.

    SIGTERM ends each binary with 0 within 10 s.  The sizes: a hollow
    kubelet rewrites a running pod's status on every event of the pod,
    its own writes' included, PLEG once more each second, and every
    node's handler sees every pod event (ROADMAP R14(a)), which sets how
    many nodes and pods one binary holds (PERF.md section 4).  Returns
    the scheduler's counts (as --binary-child prints them), the times
    from the flood's write to the last bind and to the last pod Ready,
    the registration's, the crash backoff and R14(d)'s restored and
    terminal pods."""
    import tempfile

    from kubernetes_tpu_torch.client.http_client import HTTPClient
    from kubernetes_tpu_torch.kubelet.checkpoint import CheckpointManager
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        _bulk_create, _default_pod)

    root = str(Path(__file__).resolve().parent)
    me = str(Path(__file__).resolve())
    n_cap = caps_for_nodes(nodes + 1).n_cap
    children, watch = [], None
    with tempfile.TemporaryDirectory(prefix="phase35-") as tmp:
        try:
            t_run0 = time.monotonic()
            api, url = apiserver_child(
                tmp, (f"{KUBELET_ADMIN},phase35,system:masters",
                      f"{KUBELET_SCHED},system:kube-scheduler"),
                "35 apiserver", root)
            children.append(api)
            killed = set()
            alive = alive_check(children, killed)
            api.wait_line("apiserver listening on", "the apiserver start",
                          timeout=KUBELET_STEP_S)
            admin = HTTPClient.from_url(url, token=KUBELET_ADMIN)
            watch = PodWatch(admin)
            used0, _apps = device_memory()
            kubelet_argv = [sys.executable, "-u", "-m",
                            "kubernetes_tpu_torch.cmd.kubelet", "--server",
                            url, "--token", KUBELET_ADMIN]
            # the scheduler and the hollow kubelet start together: the
            # scheduler's informers take the nodes as they register
            t0 = time.monotonic()
            sched = ChildLog(
                [sys.executable, "-u", me, "--binary-child", "--server", url,
                 "--token", KUBELET_SCHED, "--tpu-batch", "--batch-size",
                 str(batch), "--node-capacity", str(n_cap), "--device",
                 device], "35 scheduler binary", root)
            children.append(sched)
            hollow = ChildLog(kubelet_argv + ["--hollow-nodes", str(nodes)],
                              "35 hollow kubelet", root)
            children.append(hollow)
            t_reg, _ = hollow.wait_line(
                rf"kubemark: {nodes} hollow nodes registered",
                "the hollow nodes' registration", timeout=KUBELET_STEP_S)
            reg_s = t_reg - t0
            want = {f"hollow-{i}" for i in range(nodes)}
            got_nodes = {n["metadata"]["name"]
                         for n in admin.list("nodes")[0]}
            check(want <= got_nodes,
                  f"35: {len(want - got_nodes)} hollow nodes missing")
            leases0 = lease_times(admin)
            check(want <= set(leases0),
                  f"35: {len(want - set(leases0))} Leases missing")
            t_s, _ = sched.wait_line(
                r"scheduler running \(tpu-batch profile\)",
                "the scheduler binary's start", timeout=KUBELET_STEP_S)
            print(f"   {nodes} hollow nodes and their Leases registered "
                  f"{reg_s:.3f} s after the kubelet binary started; the "
                  f"scheduler binary running at {t_s - t0:.3f} s (n_cap "
                  f"{n_cap}, batch {batch}) [{smi}]", flush=True)

            t_flood = time.monotonic()
            _bulk_create(admin, "pods", pods, 0, _default_pod,
                         {"podNamePrefix": "pod-"})
            t_sent = time.monotonic()
            t_bound = watch.wait_bound(pods, "default/pod-", "the flood",
                                       alive, timeout=KUBELET_STEP_S)
            t_run = watch.wait_until(
                lambda: watch.ready("default/pod-") >= pods,
                lambda: f"{pods} pods Running and Ready (Ready: "
                        f"{watch.ready('default/pod-')})", alive)
            check(not watch.changed, f"35: nodeName changed: "
                                     f"{watch.changed[:5]}")
            check(len(watch.binds) == pods
                  and set(watch.binds.values()) == {1},
                  f"35: {len(watch.binds)} pods bound, bind counts "
                  f"{sorted(set(watch.binds.values()))}")
            wrong = [k for k in watch.ready_at
                     if watch.ready_node[k] != watch.node[k]]
            check(not wrong, f"35: Running on another node than bound: "
                             f"{wrong[:5]}")
            many = {n: ips for n, ips in watch.host_ips.items()
                    if len(ips) != 1}
            check(not many, f"35: nodes with several hostIPs: "
                            f"{list(many.items())[:5]}")
            used = check_binary_caps(admin, pods, "35")
            lat = sorted((watch.ready_at[k] - watch.added[k]) * 1e3
                         for k in watch.ready_at)
            print(f"   (i) {pods} pods in one bulk write "
                  f"{t_sent - t_flood:.3f} s; all bound "
                  f"{t_bound - t_flood:.3f} s, all Running and Ready "
                  f"{t_run - t_flood:.3f} s after the write began; pod "
                  f"created to Ready p50 {lat[len(lat) // 2]:.2f} ms p99 "
                  f"{lat[min(len(lat) - 1, int(len(lat) * 0.99))]:.2f} ms; "
                  f"pods on {used} nodes [{smi}]", flush=True)

            # (ii) the full kubelet
            full_root = Path(tmp) / KUBELET_FULL
            full_argv = kubelet_argv + ["--full", "--node-name",
                                        KUBELET_FULL, "--root-dir",
                                        str(full_root)]
            t_full = time.monotonic()
            full = ChildLog(full_argv, "35 full kubelet", root)
            children.append(full)
            full.wait_line(rf"kubelet \(full\) running as node "
                           rf"{KUBELET_FULL}", "the full kubelet's start",
                           timeout=KUBELET_STEP_S)
            for pod in full_pods():
                admin.create("pods", pod)
            watch.wait_until(lambda: watch.ready_node.get("default/probed")
                             == KUBELET_FULL, "the probed pod Ready on "
                             f"{KUBELET_FULL}", alive)
            watch.wait_until(lambda: "default/crashy" in watch.node,
                             "the crashing pod bound", alive)
            check(watch.node["default/crashy"] == KUBELET_FULL,
                  f"35: the crashing pod on {watch.node['default/crashy']}")

            def restarts():
                return [float(hit[1]) for _t, line in full.lines[:]
                        for hit in [re.search(r"restarted container "
                                              r"crashy/c0 \(backoff "
                                              r"([0-9.]+)s\)", line)]
                        if hit]
            t_2 = watch.wait_until(lambda: len(restarts()) >= 2,
                                   "two restarts of the crashing container",
                                   alive, poll=0.05)
            backoff = tuple(restarts()[:2])
            check(backoff == (0.25, 0.5),
                  f"35: the crashing container's backoff {backoff}")
            # R14(e): a Failed report precedes the first restart
            watch.wait_until(lambda: "Failed" in watch.phases.get(
                "default/crashy", ()), "the crashing pod read Failed", alive)
            crash_states = watch.states.get("default/crashy", [])
            uids = {watch.uid["default/probed"], watch.uid["default/crashy"]}
            ckpt = CheckpointManager(str(full_root))

            def checkpointed():
                try:
                    return uids <= set(ckpt.get_checkpoint("pod_state"))
                except (KeyError, ValueError):
                    return False
            watch.wait_until(checkpointed, "the checkpoint of both pods",
                             alive, poll=0.1)
            killed.add(full)
            full.proc.kill()
            full.proc.wait()
            full._reader.join(timeout=5)
            t_kill = time.monotonic()
            # the statuses as the killed kubelet left them: a terminal one
            # stays as it is (no sync or relist touches a terminal pod),
            # a running one turns R14(d)'s after the restart
            before = {k: admin.get("pods", "default", k.split("/")[1])
                      .get("status") or {} for k in
                      ("default/probed", "default/crashy")}
            terminal = {k for k, st in before.items()
                        if st.get("phase") in ("Succeeded", "Failed")}
            check("default/probed" not in terminal,
                  f"35: the probed pod read {before['default/probed']}")
            full2 = ChildLog(full_argv, "35 full kubelet, restarted", root)
            children.append(full2)
            full2.wait_line(rf"kubelet \(full\) running as node "
                            rf"{KUBELET_FULL}", "the restart",
                            timeout=KUBELET_STEP_S)
            t_r = watch.wait_until(
                lambda: all(restored_status(watch.status[k])
                            for k in before if k not in terminal),
                "R14(d)'s statuses after the restart", alive)
            after = {k: admin.get("pods", "default", k.split("/")[1])
                     .get("status") or {} for k in before}
            for k in terminal:
                check(after[k] == before[k],
                      f"35: the restart rewrote {k}'s terminal status: "
                      f"{after[k]}")
            print(f"   (ii) the full kubelet: probed pod Ready "
                  f"{watch.ready_at['default/probed'] - t_full:.3f} s after "
                  f"the binary started; the crashing container restarted "
                  f"with backoff {backoff[0]} s then {backoff[1]} s "
                  f"({t_2 - t_full:.3f} s in), its pod's phases "
                  f"{sorted(watch.phases['default/crashy'])} (Failed: "
                  f"R14(e)), its container states "
                  f"{[s[0] for s in crash_states][:6]}; SIGKILL and "
                  f"restart on the same root dir: "
                  f"{sorted(set(before) - terminal)} read Running, "
                  f"Ready=False, containerStatuses [] "
                  f"{t_r - t_kill:.3f} s after the kill (R14(d)), "
                  f"{sorted(terminal)} kept their terminal status; hostIP "
                  f"{before['default/probed'].get('hostIP')} before, "
                  f"{after['default/probed'].get('hostIP')} after (R14(b)) "
                  f"[{smi}]", flush=True)

            # every node's Lease renewed at least once
            stale = set(want)

            def renewed():
                now = lease_times(admin)
                for name in list(stale):
                    if (now.get(name) or 0) > (leases0[name] or 0):
                        stale.discard(name)
                return not stale
            t_l = watch.wait_until(renewed, "every hollow node's Lease "
                                   "renewed", alive, poll=0.5)
            print(f"   every Lease's renewTime advanced by "
                  f"{t_l - t_reg:.3f} s after the registration", flush=True)

            used1, apps1 = device_memory()
            cpu = {c.name: process_cpu_s(c.proc.pid)
                   for c in (hollow, full2, sched, api)}
            rss = {c.name: process_rss_mib(c.proc.pid)
                   for c in (hollow, api)}
            wall = time.monotonic() - t0
            killed.update(children)   # from here on exits are expected
            term = {}
            since = len(sched.lines)
            for child in (hollow, full2, sched):
                child.proc.send_signal(signal.SIGTERM)
                t_term = time.monotonic()
                try:
                    rc = child.proc.wait(timeout=KUBELET_TERM_S)
                except subprocess.TimeoutExpired:
                    raise SystemExit(f"CHECK FAILED: 35: {child.name} "
                                     f"outlived SIGTERM by "
                                     f"{KUBELET_TERM_S} s") from None
                term[child.name] = time.monotonic() - t_term
                child._reader.join(timeout=5)
                check(rc == 0, f"35: {child.name} exited {rc}")
            _t, hit = sched.wait_line(re.escape(CHILD_TAG) + "(.*)",
                                      "its launch count", since)
            got = json.loads(hit[1])
            print(f"   the kubelet processes' CPU over their "
                  f"{wall:.3f} s: {', '.join(f'{k} {v:.3f} s' for k, v in cpu.items())}; "
                  f"resident MiB and threads "
                  f"{', '.join(f'{k} {v[0]:.0f} / {v[1]}' for k, v in rss.items())}; "
                  f"SIGTERM to exit "
                  f"{', '.join(f'{k} {v:.3f} s' for k, v in term.items())} "
                  f"[{smi}]", flush=True)
            print(f"   device memory (nvidia-smi memory.used, MiB): "
                  f"{used0:.0f} before the binaries, {used1:.0f} with the "
                  f"scheduler warm; compute apps (pid, MiB) {apps1!r} "
                  f"[{smi}]", flush=True)
            print(f"   scheduler binary: claims launches "
                  f"{got['launches']['claims']}, escapes {got['escaped']} "
                  f"{got['by_reason']}, batches {got['batches']} (plain "
                  f"{got['plain']}, waves {got['waves']}) on "
                  f"{got.get('device')} [{smi}]", flush=True)
            api.proc.send_signal(signal.SIGTERM)
            check(api.proc.wait(timeout=30) == 0,
                  f"35: the apiserver exited {api.proc.returncode}")
            print(f"   35: registration {reg_s:.3f} s, bind "
                  f"{t_bound - t_flood:.3f} s, Running "
                  f"{t_run - t_flood:.3f} s; the run "
                  f"{time.monotonic() - t_run0:.3f} s [{smi}]", flush=True)
            return {"scheduler": got, "registration_s": reg_s,
                    "bind_s": t_bound - t_flood, "running_s": t_run - t_flood,
                    "backoff": backoff, "restored": sorted(set(before)
                                                           - terminal),
                    "terminal": sorted(terminal), "crashy_phases":
                    sorted(watch.phases["default/crashy"])}
        finally:
            if watch is not None:
                watch.close()
            for child in reversed(children):
                child.stop()


def kubelet_phase(smi, **kw):
    """Phase 35: kubelet_run at its defaults with the scheduler binary on
    the card, and on top of its checks: the binary launched the claims
    kernel and sent no pod to the per-pod path.  Returns its claims
    launches."""
    with Phase("35 the node agent on the card"):
        got = kubelet_run(smi, **kw)["scheduler"]
        check(got["launches"]["claims"] > 0,
              "35: the scheduler never launched the claims kernel")
        check(got["escaped"] == 0 and not got["by_reason"],
              f"35: the scheduler sent pods to the per-pod path: {got}")
    return got["launches"]["claims"]


# phase 36: the all-in-one cluster (cmd/cluster.py) in one process: the
# apiserver, the scheduler on the card, the controller manager, the
# Endpoints controller and CLUSTER_NODES hollow nodes, with a Deployment
# of CLUSTER_REPLICAS kubemark-sized pods rolled out, updated and deleted
CLUSTER_NODES = 500       # hollow nodes, in the cluster's own process
CLUSTER_REPLICAS = 250    # the Deployment's replicas
CLUSTER_BATCH = 4096
CLUSTER_STEP_S = 60.0     # every wait of phase 36, s
CLUSTER_TERM_S = 10.0     # SIGTERM to exit, s
CLUSTER_STEADY_S = 5.0    # the steady state whose writes are counted, s
CLUSTER_SLICE_MAX = 100   # endpoints an EndpointSlice holds
CLUSTER_TAG = "cluster-child: "
CLUSTER_BATCH_TAG = "cluster-child batch: "
CLUSTER_WAVE_TAG = "cluster-child wave: "
CLUSTER_WATCHED = ("pods", "nodes", "leases", "endpoints", "endpointslices",
                   "replicasets", "deployments", "services", "events")


def cluster_child(argv):
    """--cluster-child ARGS: kubernetes_tpu_torch.cmd.cluster.main(ARGS),
    unchanged, instrumented by instrument_child: its counts after every
    batch (CLUSTER_BATCH_TAG) and, once main returns, after CLUSTER_TAG;
    then the first claims wave with a live pod after the warmup, held
    against the plain version and timed (CLUSTER_WAVE_TAG).  Before the
    check it stops the informers main leaves running: their pod events
    would keep the stopped hollow kubelets rewriting statuses (ROADMAP
    R14(g)) beside it."""
    from kubernetes_tpu_torch.client.informer import SharedInformerFactory
    from kubernetes_tpu_torch.cmd import cluster as cmd

    counts, finish, rec = instrument_child(CLUSTER_BATCH_TAG, record=True)
    factories, init = [], SharedInformerFactory.__init__

    def kept(self, *a, **kw):
        init(self, *a, **kw)
        factories.append(self)
    SharedInformerFactory.__init__ = kept
    with rec:
        cmd.main(argv)
    finish()
    print(CLUSTER_TAG + json.dumps(counts()), flush=True)
    for factory in factories:
        factory.stop()
    if "wave" in rec.kept:
        print(CLUSTER_WAVE_TAG + json.dumps(recorded_wave(rec, "36")),
              flush=True)
    return 0


class ClusterWatch(PodWatch):
    """PodWatch plus the pods that were deleted and the most pods that
    lived at once."""

    phase = "36"
    step_s = CLUSTER_STEP_S

    def __init__(self, client):
        self.deleted, self.peak = set(), 0
        super().__init__(client)

    def _event(self, ev, now):
        key = super()._event(ev, now)
        if ev.type == "DELETED":
            self.deleted.add(key)
        self.peak = max(self.peak, len(self.added) - len(self.deleted))
        return key

    def created(self, prefix):
        return [k for k in list(self.added) if k.startswith(prefix)]

    def live(self, prefix):
        return [k for k in self.created(prefix) if k not in self.deleted]


def web_deployment(replicas, image):
    """The phase's Deployment: kubemark-sized pods (100m, 128Mi)."""
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "web", "namespace": "default"},
            "spec": {"replicas": replicas,
                     "selector": {"matchLabels": {"app": "web"}},
                     "template": {
                         "metadata": {"labels": {"app": "web"}},
                         "spec": {"containers": [{
                             "name": "c0", "image": image,
                             "resources": {"requests": {
                                 "cpu": "100m", "memory": "128Mi"}}}]}}}}


WEB_SERVICE = {"apiVersion": "v1", "kind": "Service",
               "metadata": {"name": "web", "namespace": "default"},
               "spec": {"selector": {"app": "web"},
                        "ports": [{"name": "http", "port": 80,
                                   "protocol": "TCP"}]}}


def template_hash(template):
    """pod-template-hash, recomputed here: the first ten hex digits of
    the SHA-1 of the template's sorted-key JSON."""
    import hashlib
    canon = json.dumps(template, sort_keys=True)
    return hashlib.sha1(canon.encode()).hexdigest()[:10]


def slice_group_id(ports):
    """The EndpointSlice name's port-group id, recomputed here: the SHA-256
    of the repr of the group's (name, port, protocol) tuples."""
    import hashlib
    key = tuple((p["name"], p["port"], p["protocol"]) for p in ports)
    return hashlib.sha256(repr(key).encode()).hexdigest()[:8]


def normalized_state(client):
    """What the cluster holds of the phase's objects, with what a run
    chooses at random or by the clock taken out: the Deployment's spec
    and status, each ReplicaSet's name, labels, replicas and status, the
    pods by name up to their random suffix with their phase, the
    Endpoints' and EndpointSlices' address counts by readiness, and the
    slices' names.  Pod placement, IPs and node names are left out (they
    follow the random pod names and the process's hash seed)."""
    out = {"deployments": {}, "replicasets": {}, "pods": {},
           "endpoints": {}, "endpointslices": {}}
    for d in client.list("deployments", "default")[0]:
        st = d.get("status") or {}
        out["deployments"][d["metadata"]["name"]] = {
            "replicas": d["spec"].get("replicas"),
            "status": {k: st.get(k) for k in (
                "replicas", "readyReplicas", "updatedReplicas",
                "availableReplicas")}}
    for rs in client.list("replicasets", "default")[0]:
        out["replicasets"][rs["metadata"]["name"]] = {
            "labels": rs["metadata"].get("labels"),
            "replicas": rs["spec"].get("replicas"),
            "status": {k: (rs.get("status") or {}).get(k) for k in (
                "replicas", "readyReplicas")}}
    for p in client.list("pods", "default")[0]:
        name = re.sub(r"-[0-9a-f]{5}-[0-9a-f]{5}$", "-*",
                      p["metadata"]["name"])
        phase = (p.get("status") or {}).get("phase")
        out["pods"][f"{name} {phase}"] = \
            out["pods"].get(f"{name} {phase}", 0) + 1
    for ep in client.list("endpoints", "default")[0]:
        out["endpoints"][ep["metadata"]["name"]] = sorted(
            len(s.get("addresses") or ()) for s in ep.get("subsets") or ())
    for sl in client.list("endpointslices", "default")[0]:
        eps = sl.get("endpoints") or ()
        out["endpointslices"][sl["metadata"]["name"]] = {
            "ready": sum(1 for e in eps if e["conditions"]["ready"]),
            "endpoints": len(eps), "ports": sl.get("ports")}
    return out


def cluster_run(smi, nodes=CLUSTER_NODES, replicas=CLUSTER_REPLICAS,
                batch=CLUSTER_BATCH, device="cuda", argv=None,
                term_s=CLUSTER_TERM_S):
    """Phase 36's run: the port's all-in-one cluster, python -m
    kubernetes_tpu_torch.cmd.cluster --secure-port 0 --nodes N --tpu-batch
    --batch-size B --device D, as one process through this script's
    --cluster-child entry (which counts its claims launches and escapes
    and checks its first live wave), driven over the port's HTTPClient.
    `argv` replaces the command before --secure-port (the tests run the
    JAX package's binary through it).

    (1) The cluster comes up: N hollow nodes and their Leases register;
    the controllers the manager started and disabled are read from its
    log.  (2) A Service and a Deployment of R replicas (100m, 128Mi) in
    one namespace: one ReplicaSet named web-<pod-template-hash> (the hash
    recomputed here), R pods bound exactly once within caps, each Running
    and Ready on the node it was bound to, the Service's Endpoints and
    EndpointSlices (their group id recomputed here) listing exactly the
    R pods' IPs.  (3) The pod template changes: a second ReplicaSet
    reaches R Ready pods, the first drains to 0 and its pods go, and the
    Endpoints and slices follow; the most pods alive at once is printed
    (ROADMAP R15: the new ReplicaSet surges the whole count).  (4)
    CLUSTER_STEADY_S s of steady state: the store's writes, in all (its
    resourceVersion) and by resource (a watch each), per second (ROADMAP
    R14(a) as the controllers amplify it).  (5) The Deployment is deleted
    with propagationPolicy Background: the garbage collector removes both
    ReplicaSets and every pod.  (6) SIGTERM: the process exits 0 within
    CLUSTER_TERM_S s.

    Returns the child's counts (as --cluster-child prints them; None for
    another binary), its recorded wave, the step times and the normalized
    state after (3) and after (5)."""
    from kubernetes_tpu_torch.client.http_client import HTTPClient

    root = str(Path(__file__).resolve().parent)
    me = str(Path(__file__).resolve())
    ours = argv is None
    if ours:
        argv = [sys.executable, "-u", me, "--cluster-child"]
    times, child, watch = {}, None, None
    try:
        t_run0 = time.monotonic()
        # port 0: the apiserver binds a free port and the "cluster up"
        # line names it
        child = ChildLog(
            argv + ["--secure-port", "0", "--nodes", str(nodes),
                    "--tpu-batch", "--batch-size", str(batch),
                    *(["--device", device] if ours else [])],
            "36 cluster", root)
        killed = set()
        alive = alive_check([child], killed)
        # (1) up: the line comes once every hollow node has started
        t_up, hit = child.wait_line(r"cluster up: apiserver=(\S+)",
                                    "the cluster's start",
                                    timeout=CLUSTER_STEP_S)
        times["up"] = t_up - t_run0
        admin = HTTPClient.from_url(hit[1])
        want_nodes = {f"hollow-{i}" for i in range(nodes)}
        watch = ClusterWatch(admin)

        def registered():
            got = {n["metadata"]["name"] for n in admin.list("nodes")[0]}
            return want_nodes <= got and want_nodes <= set(
                lease_times(admin))
        t_reg = watch.wait_until(registered, f"{nodes} nodes and their "
                                 f"Leases registered", alive, poll=0.1)
        times["registered"] = t_reg - t_run0
        started = sorted({hit[1] for _t, line in child.lines[:]
                          for hit in [re.search(
                              r"starting controller (\S+)", line)]
                          if hit})
        disabled = sorted({hit[1] for _t, line in child.lines[:]
                           for hit in [re.search(
                               r"controller (\S+) disabled", line)]
                           if hit})
        print(f"   (1) the cluster up {times['up']:.3f} s after the "
              f"process started, {nodes} nodes and Leases registered "
              f"at {times['registered']:.3f} s; the manager started "
              f"{len(started)} controllers, disabled {disabled or 'none'} "
              f"[{smi}]", flush=True)

        # (2) the rollout
        admin.create("services", WEB_SERVICE)
        t2 = time.monotonic()
        admin.create("deployments", web_deployment(replicas, "img:v1"))
        rs1 = check_rollout(admin, watch, alive, replicas, "(2)")
        times["rollout"] = time.monotonic() - t2
        used = check_binary_caps(admin, replicas, "36 (2)")
        lat = sorted((watch.ready_at[k] - watch.added[k]) * 1e3
                     for k in watch.ready_at)
        made = {rs1: len(watch.created(f"default/{rs1}-"))}
        print(f"   (2) Deployment of {replicas}: ReplicaSet {rs1}, "
              f"{replicas} pods bound once within caps on {used} "
              f"nodes, Running and Ready, in the Endpoints and the "
              f"EndpointSlices {times['rollout']:.3f} s after the "
              f"create ({made[rs1]} pods created for it, ROADMAP "
              f"R16); created to Ready p50 "
              f"{lat[len(lat) // 2]:.2f} ms p99 "
              f"{lat[min(len(lat) - 1, int(len(lat) * 0.99))]:.2f} ms "
              f"[{smi}]", flush=True)

        # (3) the update
        def new_image(o):
            o["spec"]["template"]["spec"]["containers"][0]["image"] = \
                "img:v2"
            return o
        t3 = time.monotonic()
        cur = admin.get("deployments", "default", "web")
        admin.update("deployments", new_image(cur))
        rs2 = check_rollout(admin, watch, alive, replicas, "(3)",
                            old=rs1)
        times["update"] = time.monotonic() - t3
        check_binary_caps(admin, replicas, "36 (3)")
        updated = normalized_state(admin)
        made[rs2] = len(watch.created(f"default/{rs2}-"))
        print(f"   (3) template changed: ReplicaSet {rs2} at "
              f"{replicas} Ready pods ({made[rs2]} created for it, "
              f"R16), {rs1} drained to 0 and its pods "
              f"gone, the Endpoints and slices on the new pods "
              f"{times['update']:.3f} s after the update; at most "
              f"{watch.peak} pods alive at once (ROADMAP R15) [{smi}]",
              flush=True)

        # (4) the steady state's writes
        writes = steady_writes(admin)
        total = writes.pop("total")
        made = {rs: len(watch.created(f"default/{rs}-")) for rs in made}
        print(f"   (4) steady state over {CLUSTER_STEADY_S} s: "
              f"{total / CLUSTER_STEADY_S:.1f} store writes/s; by "
              f"resource /s "
              f"{ {k: v / CLUSTER_STEADY_S for k, v in writes.items()} } "
              f"(R14(a)); pods created by ReplicaSet so far {made} (R16) "
              f"[{smi}]", flush=True)

        # (5) the delete
        t5 = time.monotonic()
        admin.delete("deployments", "default", "web",
                     propagation_policy="Background")

        def collected():
            return not admin.list("replicasets", "default")[0] and \
                not admin.list("pods", "default")[0]
        watch.wait_until(collected, "both ReplicaSets and every pod "
                         "collected", alive, poll=0.05)
        times["delete"] = time.monotonic() - t5
        watch.wait_until(
            lambda: not admin.get("endpoints", "default", "web")
            .get("subsets"), "the Endpoints emptied", alive, poll=0.05)
        deleted = normalized_state(admin)
        check(not watch.changed, f"36: nodeName changed: "
                                 f"{watch.changed[:5]}")
        check(set(watch.binds.values()) <= {1},
              f"36: bind counts {sorted(set(watch.binds.values()))}")
        made = {rs: len(watch.created(f"default/{rs}-")) for rs in made}
        print(f"   (5) Background delete: both ReplicaSets and "
              f"{len(watch.binds)} pods collected "
              f"{times['delete']:.3f} s after the delete; pods created "
              f"in the run by ReplicaSet {made} (R16) [{smi}]",
              flush=True)

        # (6) SIGTERM
        cpu = process_cpu_s(child.proc.pid)
        rss, threads = process_rss_mib(child.proc.pid)
        wall = time.monotonic() - t_run0
        killed.add(child)
        since = len(child.lines)
        child.proc.send_signal(signal.SIGTERM)
        t_term = time.monotonic()
        try:
            rc = child.proc.wait(timeout=term_s)
        except subprocess.TimeoutExpired:
            raise SystemExit(f"CHECK FAILED: 36: the cluster outlived "
                             f"SIGTERM by {term_s} s") from None
        times["term"] = time.monotonic() - t_term
        child._reader.join(timeout=5)
        check(rc == 0, f"36: the cluster exited {rc}; its last lines "
                       f"{[line[:300] for _t, line in child.lines[-8:]]}")
        got = wave = None
        main_s = ""
        if ours:
            t_main, hit = child.wait_line(re.escape(CLUSTER_TAG) + "(.*)",
                                          "its launch count", since)
            got = json.loads(hit[1])
            main_s = f" (main returned at {t_main - t_term:.3f} s)"
            hit = child.find(re.escape(CLUSTER_WAVE_TAG) + "(.*)", since)
            check(hit is not None, "36: the cluster recorded no wave")
            wave = json.loads(hit[1][1])
        print(f"   (6) SIGTERM to exit {times['term']:.3f} s{main_s}; the "
              f"process over its {wall:.3f} s: CPU {cpu:.3f} s, "
              f"resident {rss:.0f} MiB, {threads} threads [{smi}]",
              flush=True)
        print(f"   36: up {times['up']:.3f} s, registered "
              f"{times['registered']:.3f} s, rollout "
              f"{times['rollout']:.3f} s, update {times['update']:.3f} "
              f"s, delete {times['delete']:.3f} s; the run "
              f"{time.monotonic() - t_run0:.3f} s [{smi}]", flush=True)
        return {"cluster": got, "wave": wave, "times": times,
                "started": started, "disabled": disabled,
                "peak": watch.peak, "made": made, "updated": updated,
                "deleted": deleted, "writes": writes, "total": total}
    finally:
        if watch is not None:
            watch.close()
        if child is not None:
            child.stop()


def check_rollout(admin, watch, alive, replicas, step, old=None):
    """Wait until the Deployment's ReplicaSet for its current template
    (web-<hash>, the hash recomputed here) holds `replicas` Ready pods,
    each Running on the node it was bound to, `old` (the previous
    ReplicaSet) is scaled to 0 with its pods gone, and the Service's
    Endpoints and EndpointSlices list exactly the new pods' IPs.  Returns
    the ReplicaSet's name."""
    dep = admin.get("deployments", "default", "web")
    thash = template_hash(dep["spec"]["template"])
    rs = f"web-{thash}"
    prefix = f"default/{rs}-"
    watch.wait_until(lambda: len(watch.ready_at.keys() & set(
        watch.live(prefix))) >= replicas,
        lambda: f"36 {step}: {replicas} pods of {rs} Ready (Ready: "
                f"{len(watch.ready_at.keys() & set(watch.live(prefix)))})",
        alive)
    got = admin.get("replicasets", "default", rs)
    check(got["metadata"]["labels"].get("pod-template-hash") == thash,
          f"36 {step}: {rs}'s labels {got['metadata']['labels']}")
    if old is not None:
        left = f"default/{old}-"
        watch.wait_until(
            lambda: not watch.live(left) and admin.get(
                "replicasets", "default", old)["spec"]["replicas"] == 0,
            lambda: f"36 {step}: {old} drained ({len(watch.live(left))} "
                    f"pods left)", alive)
    live = watch.live(prefix)
    check(len(live) == replicas, f"36 {step}: {len(live)} pods of {rs}")
    wrong = [k for k in live if watch.ready_node[k] != watch.node[k]]
    check(not wrong, f"36 {step}: Running on another node than bound: "
                     f"{wrong[:5]}")
    ips = {watch.status[k].get("podIP") for k in live}
    check(len(ips) == replicas, f"36 {step}: {len(ips)} pod IPs")
    gid = slice_group_id(WEB_SERVICE["spec"]["ports"])

    def listed():
        ep = admin.get("endpoints", "default", "web")
        in_ep = {a["ip"] for s in ep.get("subsets") or ()
                 for a in s.get("addresses") or ()}
        slices = admin.list("endpointslices", "default")[0]
        in_sl = {e["addresses"][0] for sl in slices
                 for e in sl.get("endpoints") or ()
                 if e["conditions"]["ready"]}
        names = {sl["metadata"]["name"] for sl in slices}
        return (in_ep == ips and in_sl == ips and names == {
            f"web-{gid}-{i}"
            for i in range(-(-replicas // CLUSTER_SLICE_MAX))})
    watch.wait_until(listed, f"36 {step}: the Endpoints and EndpointSlices "
                     f"(web-{gid}-*) on {rs}'s {replicas} pod IPs", alive,
                     poll=0.05)
    return rs


def steady_writes(admin):
    """The store's writes over CLUSTER_STEADY_S s: in all (the
    resourceVersion's advance) and by resource (a watch on each of
    CLUSTER_WATCHED from the starting resourceVersion)."""
    _items, rv0 = admin.list("namespaces")
    watches = {res: admin.watch(res, since_rv=rv0)
               for res in CLUSTER_WATCHED}
    counts = dict.fromkeys(CLUSTER_WATCHED, 0)
    t_end = time.monotonic() + CLUSTER_STEADY_S
    try:
        while time.monotonic() < t_end:
            for res, w in watches.items():
                counts[res] += len(w.next_batch(timeout=0.01))
        _items, rv1 = admin.list("namespaces")
        for res, w in watches.items():   # what arrived up to rv1
            for ev in w.next_batch(timeout=0.2):
                counts[res] += int(
                    ev.object["metadata"]["resourceVersion"]) <= rv1
    finally:
        for w in watches.values():
            w.stop()
    return {**counts, "total": rv1 - rv0}


def cluster_phase(smi, **kw):
    """Phase 36: cluster_run at its defaults with the scheduler on the
    card, and on top of its checks: it launched the claims kernel, sent
    no pod to the per-pod path, and its first live wave equals the plain
    version.  Returns its claims launches and the wave's max |best err|."""
    with Phase("36 the all-in-one cluster on the card"):
        got = cluster_run(smi, **kw)
        counts, wave = got["cluster"], got["wave"]
        check(counts["launches"]["claims"] > 0,
              "36: the cluster never launched the claims kernel")
        check(counts["escaped"] == 0 and not counts["by_reason"],
              f"36: the scheduler sent pods to the per-pod path: {counts}")
        print(f"   36 cluster: claims launches "
              f"{counts['launches']['claims']}, escapes {counts['escaped']} "
              f"{counts['by_reason']}, batches {counts['batches']} (plain "
              f"{counts['plain']}, waves {counts['waves']}) on "
              f"{counts.get('device')}, reserved "
              f"{counts.get('reserved_mib', 0.0):.1f} MiB (peak "
              f"{counts.get('peak_reserved_mib', 0.0):.1f}); first wave "
              f"{wave['shape']} ({wave['live']} live pods, {wave['noise']}) "
              f"max |best err| {wave['max_abs_err']}, {wave['ms']:.4f} "
              f"ms/launch, plain version {wave['plain_ms']:.4f} ms, bound "
              f"{wave['bound_ms']:.4f} ms ({wave['bound_by']}) [{smi}]",
              flush=True)
    return counts["launches"]["claims"], wave["max_abs_err"]


def busy_card(seconds):
    """Keep the card busy for `seconds`: back-to-back f32 matmuls."""
    a = torch.randn(4096, 4096, device="cuda")
    t_end = time.monotonic() + seconds
    while time.monotonic() < t_end:
        for _ in range(20):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()
    return 0


def slice_runs(n_runs, parallel=2):
    """ROADMAP Q4: phases 1-4 of this script in `n_runs` fresh processes
    (`parallel` at a time), each building the kernels cold into a
    directory of its own; a process that keeps the card busy with
    matmuls runs beside the second half.  Phase 4 in each holds the GPU
    slice to the CPU's at both noises; a process fails when it does not
    agree (or any check of phases 1-4 fails)."""
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="slice-runs-"))
    me = str(Path(__file__).resolve())
    busy = None
    results, running = [], []
    for i in range(n_runs):
        if i == n_runs // 2:
            busy = subprocess.Popen([sys.executable, me, "--busy", "3600"])
        while len(running) >= parallel:
            results.append(_reap(running.pop(0)))
        running.append((i, busy is not None, subprocess.Popen(
            [sys.executable, me, "--until", "4", "--build-dir",
             str(tmp / f"build-{i}")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    while running:
        results.append(_reap(running.pop(0)))
    if busy is not None:
        busy.terminate()
        busy.wait()
    bad = [r for r in results if r["rc"] != 0]
    print(f"   slice runs: {len(results)} fresh processes of phases 1-4 "
          f"({n_runs // 2} alone, {n_runs - n_runs // 2} beside a busy "
          f"card), {len(bad)} failed: {[r['i'] for r in bad]}", flush=True)
    return 1 if bad else 0


def _reap(entry):
    i, busy, proc = entry
    out, _ = proc.communicate()
    lines = out.strip().splitlines()
    agree = [ln.strip() for ln in lines if "bit-identical; waves" in ln]
    built = [ln.strip() for ln in lines if ln.strip().startswith("build ")]
    print(f"   run {i} (busy card {busy}) rc {proc.returncode}: "
          f"{built[-1] if built else ''}; {agree}", flush=True)
    if proc.returncode != 0:
        print("\n".join(lines[-40:]), flush=True)
    return {"i": i, "rc": proc.returncode, "busy": busy}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="TAG=DIR",
                    help="a checkout of another revision whose claims "
                         "and dry-run wrappers to time beside this one's")
    ap.add_argument("--only", choices=("seam", "sharded", "snapshot",
                                       "http", "scaleout", "binary", "proc",
                                       "replica", "kubelet", "cluster"),
                    help="phases 1-2 and then only these (seam: 22-25, "
                         "sharded: 26-27, snapshot: 28-29, http: 30, "
                         "scaleout: 31, binary: 32, proc: 33, replica: "
                         "34, kubelet: 35, cluster: 36); prints no result "
                         "line")
    ap.add_argument("--slice-runs", type=int, default=0, metavar="N",
                    help="phases 1-4 in N fresh processes with cold builds, "
                         "a busy card beside the second half (ROADMAP Q4); "
                         "prints no result line")
    ap.add_argument("--until", choices=("4",),
                    help="stop after phase 4; prints no result line")
    ap.add_argument("--build-dir", default=None,
                    help="build the kernels into this directory")
    ap.add_argument("--busy", type=float, default=0.0,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def load_revision(tag, root):
    """The ops.kernels and models.preempt modules of the
    kubernetes_tpu_torch package under `root`, imported as a package of its
    own (kubernetes_tpu_torch_<tag>), so that its wrappers build and launch
    its own kernels."""
    pkg = Path(root).resolve() / "kubernetes_tpu_torch"
    name = f"kubernetes_tpu_torch_{tag}"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.ops.kernels"),
            importlib.import_module(f"{name}.models.preempt"))


def wave_shape_args(backend, P, state, dev, mixed=False):
    """The main path's claims inputs for P SchedulingBasic pods (100m,
    128Mi, no tolerations; with mixed=True every other pod requests 200m,
    256Mi) against the 100k backend's nodes, with the dynamic aggregates
    from `state`.  Returns the claims arguments and the raw inputs of
    prepare_static."""
    from kubernetes_tpu_torch.models.assign import static_mask_t, taint_bits
    from kubernetes_tpu_torch.ops import kernels
    stat = backend._static_node
    req = torch.zeros((P, backend.caps.r), device=dev)
    req[:, 0] = 100.0
    req[:, 1] = 128.0 * 2**20
    if mixed:
        req[1::2, :2] *= 2
    smask = static_mask_t(stat["valid"], taint_bits(stat["taint_mask"]),
                          torch.zeros(P, dtype=torch.int32, device=dev))
    raw = (req, req, stat["alloc"], stat["maxpods"], smask)
    return (kernels.prepare_static(*raw),
            torch.ones(P, dtype=torch.bool, device=dev),
            state["used"], state["used_nz"], state["npods"]), raw


def time_in_turns(kernels, others, args, raw, noise, pod_ids, label, smi,
                  n=10):
    """Each other revision's claims wrapper against this one's on the same
    inputs, in turns (this, other, other, this), after checking that it
    returns the same claims and best bit for bit."""
    def ours():
        return kernels.claims(*args, noise=noise, pod_ids=pod_ids)
    want = [t.clone() for t in ours()]
    for tag, other in others.items():
        o_args = (other.prepare_static(*raw), *args[1:])

        def theirs(other=other, o_args=o_args):
            return other.claims(*o_args, noise=noise, pod_ids=pod_ids)
        got = theirs()
        torch.cuda.synchronize()
        check(all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
              f"{label}: revision {tag} disagrees with this one")
        t = [time_cuda(fn, n) for fn in (ours, theirs, theirs, ours)]
        print(f"   {label} A/B this vs {tag}: this {t[0]:.4f} {t[3]:.4f} "
              f"ms, {tag} {t[1]:.4f} {t[2]:.4f} ms [{smi}]", flush=True)


class PlaneRecorder:
    """Within the block, every CPU call of kernels.sin_noise and
    kernels.fit_score (the planes the plain claims version computes its
    cells from) keeps a hash of each row of its result (the sum of the
    row's f32 bit patterns), so that a divergence can say which plane, and
    which rows of it, came out otherwise than a recomputation does,
    without keeping the planes."""

    NAMES = ("sin_noise", "fit_score")

    def __init__(self, kernels):
        self.kernels, self.rows = kernels, {n: [] for n in self.NAMES}

    @staticmethod
    def row_hash(plane):
        return plane.contiguous().view(torch.int32).to(torch.int64).sum(-1)

    def __enter__(self):
        self.inner = {n: getattr(self.kernels, n) for n in self.NAMES}
        for name in self.NAMES:
            def wrap(*args, name=name):
                out = self.inner[name](*args)
                if out.device.type == "cpu":
                    self.rows[name].append(self.row_hash(out))
                return out
            setattr(self.kernels, name, wrap)
        return self

    def __exit__(self, *exc):
        for name, fn in self.inner.items():
            setattr(self.kernels, name, fn)
        return False

    def explain(self, rec):
        """Each CPU launch's planes, recomputed from its kept inputs,
        against the row hashes taken when it ran."""
        k = self.kernels
        for i, inputs in enumerate(rec.inputs):
            static, _active, _used, used_nz, _npods, noise, ids = inputs
            P, N, _R = static["shape"]
            again = {"fit_score": k.fit_score(*k.utilizations(
                static["req_nz"], static["alloc"], used_nz))}
            if noise == "sin":
                again["sin_noise"] = k.sin_noise(
                    torch.arange(P, dtype=torch.int32) if ids is None
                    else ids, N)
            for name, plane in again.items():
                calls = self.rows[name]
                j = sum(1 for inp in rec.inputs[:i]
                        if name == "fit_score" or inp[5] == "sin")
                if j >= len(calls):
                    continue
                bad = (self.row_hash(plane) != calls[j]).nonzero().flatten()
                print(f"   CPU launch {i} {name}: {bad.numel()} rows differ "
                      f"from the run's, {bad[:1].tolist()}-"
                      f"{bad[-1:].tolist()} of {P}", flush=True)


def explain_divergence(kernels, gpu, cpu):
    """Where a GPU and a CPU run of the same slice part: for each pair of
    kept claims launches (inputs, outputs), whether their inputs are
    equal, whether each run's output is what the plain version gives on
    that run's own inputs again (and, for the GPU's, the kernel
    relaunched), and how many pods differ.  Printed before phase 4 fails,
    so a divergence names the side that moved."""
    host = torch.device("cpu")

    def same(a, b):
        return a.shape == b.shape and bool(torch.equal(a.to(host),
                                                       b.to(host)))

    for i, (gi, go, ci, co) in enumerate(zip(gpu.inputs, gpu.outputs,
                                             cpu.inputs, cpu.outputs)):
        g_static, c_static = gi[0], ci[0]
        inputs = {k: same(g_static[k], c_static[k]) for k in g_static
                  if torch.is_tensor(g_static[k])}
        inputs.update(zip(("active", "used", "used_nz", "npods"),
                          (same(a, b) for a, b in zip(gi[1:5], ci[1:5]))))
        noise, ids = gi[5], gi[6]
        again = kernels.claims(*gi[:5], noise=noise, pod_ids=ids)
        plain_g = kernels.claims_reference(
            {k: v.to(host) if torch.is_tensor(v) else v
             for k, v in g_static.items()}, *(t.to(host) for t in gi[1:5]),
            noise=noise, pod_ids=None if ids is None else ids.to(host))
        plain_c = kernels.claims_reference(*ci[:5], noise=noise,
                                           pod_ids=ci[6])
        diff = (go[0].to(host) != co[0]).nonzero().flatten()
        print(f"   launch {i} ({noise}): inputs equal "
              f"{[k for k, v in inputs.items() if v]}, differ "
              f"{[k for k, v in inputs.items() if not v]}; GPU run = "
              f"relaunch {same(go[0], again[0]) and same(go[1], again[1])},"
              f" = plain on its inputs {same(go[0], plain_g[0])}; CPU run = "
              f"plain on its inputs again {same(co[0], plain_c[0])}; "
              f"{diff.numel()} pods differ, first {diff[:8].tolist()}",
              flush=True)


def replay_launches(kernels, inputs, label, repeats=100):
    """Every kept claims launch replayed on its own inputs: the kernel
    `repeats` times against its own first result, and against the plain
    version on the GPU and on the CPU, bit for bit; and, for the sin
    launches, the noise of every (pod id, node) cell computed on the GPU
    and on the CPU.  A replay that differs from the first result fails."""
    cpu = torch.device("cpu")
    runs = unsteady = 0
    off_gpu = {"murmur": 0, "sin": 0}
    off_cpu = {"murmur": 0, "sin": 0}
    cells = noisy_off = 0
    for static, active, used, used_nz, npods, noise, ids in inputs:
        args = (static, active, used, used_nz, npods)
        P, N, _R = static["shape"]
        first = [t.clone() for t in kernels.claims(*args, noise=noise,
                                                   pod_ids=ids)]
        for _ in range(repeats):
            got = kernels.claims(*args, noise=noise, pod_ids=ids)
            unsteady += not all(bool(torch.equal(g, f))
                                for g, f in zip(got, first))
        runs += repeats
        plain = kernels.claims_reference(*args, noise=noise, pod_ids=ids)
        host = kernels.claims_reference(
            {k: v.to(cpu) if torch.is_tensor(v) else v
             for k, v in static.items()},
            *(t.to(cpu) for t in args[1:]), noise=noise,
            pod_ids=None if ids is None else ids.to(cpu))
        off_gpu[noise] += int(((first[0] != plain[0])
                               | (first[1] != plain[1])).sum())
        off_cpu[noise] += int(((first[0].cpu() != host[0])
                               | (first[1].cpu() != host[1])).sum())
        if noise == "sin":
            pid = torch.arange(P, dtype=torch.int32, device=used.device) \
                if ids is None else ids
            noisy_off += int((kernels.sin_noise(pid, N).cpu()
                              != kernels.sin_noise(pid.to(cpu), N)).sum())
            cells += P * N
    print(f"   {label}: {len(inputs)} claims launches replayed {repeats} "
          f"times each: {unsteady} of {runs} replays differ from the first; "
          f"pods whose claim or best differs from the plain version on the "
          f"GPU {off_gpu}, on the CPU {off_cpu}; sin noise cells that "
          f"differ between the GPU and the CPU: {noisy_off} of {cells}",
          flush=True)
    check(unsteady == 0, f"{label}: a replayed launch differs from the "
                         f"first on the same inputs")
    check(off_gpu["murmur"] == 0 and off_cpu["murmur"] == 0,
          f"{label}: murmur launches differ from the plain version")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--binary-child"]:
        return binary_child(argv[1:])
    if argv[:1] == ["--proc-child"]:
        return proc_child(argv[1:])
    if argv[:1] == ["--cluster-child"]:
        return cluster_child(argv[1:])
    opts = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if opts.busy:
        return busy_card(opts.busy)
    if opts.slice_runs:
        print(f"== phase Q4: phases 1-4 in {opts.slice_runs} fresh "
              f"processes", flush=True)
        return slice_runs(opts.slice_runs)
    from kubernetes_tpu_torch.models import carry
    from kubernetes_tpu_torch.ops import _build, kernels

    dev = torch.device("cuda")
    t_all = time.monotonic()
    with Phase("1 device facts"):
        smi = nvidia_smi_line()
        print(f"   nvidia-smi: {smi}")
        print(f"   torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}")
        print(f"   nvcc {_build.nvcc_path()} ninja {shutil.which('ninja')}; "
              f"PyYAML importable: "
              f"{importlib.util.find_spec('yaml') is not None}; grpc "
              f"importable (the gRPC seam, phases 23-24): "
              f"{importlib.util.find_spec('grpc') is not None}", flush=True)

    with Phase("2 kernel build"):
        if opts.build_dir:
            _build.BUILD_DIR = Path(opts.build_dir)
        t0 = time.monotonic()
        built = _build.build()
        for name, info in built.items():
            print(f"   {name}: {info['path']} "
                  f"({'cached' if info['cached'] else 'built'})")
            entry = ""
            for line in info["log"].splitlines():
                named = re.search(r"(_Z\w+)", line)
                if named and ("entry function" in line
                              or "properties for" in line):
                    entry = named.group(1)
                # the main path's instantiations: R=6 (and the fold), and
                # the dry run's R=6 one
                tpl = re.search(r"slice_kernelILi(\d+)ELi(\d+)ELb(\d)", entry)
                dry = re.search(r"dry_run_kernelILi(\d+)ELb(\d)E", entry)
                what = ("fold" if "fold_kernel" in entry else tpl and
                        f"slice R={tpl[1]} pods/thread={tpl[2]} "
                        f"{'murmur' if tpl[3] == '1' else 'sin'}")
                if ("registers" in line or "spill" in line) and (
                        (what and (what == "fold" or tpl[1] == "6"))
                        or (dry and dry[1] == "6")):
                    print(f"     {what or 'dry run R=6'}: {line.strip()}")
        print(f"   build {time.monotonic() - t0:.3f} s [{smi}]", flush=True)
        revs = {tag: load_revision(tag, root) for tag, root in
                (spec.split("=", 1) for spec in opts.compare)}
        others = {tag: r[0] for tag, r in revs.items()}
        others_preempt = {tag: r[1] for tag, r in revs.items()}
        t0 = time.monotonic()
        with ThreadPoolExecutor() as pool:   # one nvcc process each
            list(pool.map(lambda m: m._kernel_lib(),
                          [*others.values(), *others_preempt.values()]))
        if others:
            print(f"   built {sorted(others)} in "
                  f"{time.monotonic() - t0:.3f} s", flush=True)

    if opts.only == "seam":
        seam_phases(dev, smi, {})
        print("partial run (--only seam): no result line")
        return 0
    if opts.only == "sharded":
        sharded_phases(dev, smi, {})
        print("partial run (--only sharded): no result line")
        return 0
    if opts.only == "snapshot":
        snapshot_phases(dev, smi)
        print("partial run (--only snapshot): no result line")
        return 0
    if opts.only == "http":
        front_door_phase(smi)
        print("partial run (--only http): no result line")
        return 0
    if opts.only == "scaleout":
        scaleout_phase(smi)
        print("partial run (--only scaleout): no result line")
        return 0
    if opts.only == "binary":
        binary_phase(smi)
        print("partial run (--only binary): no result line")
        return 0
    if opts.only == "proc":
        proc_phase(smi)
        print("partial run (--only proc): no result line")
        return 0
    if opts.only == "replica":
        replica_phase(smi)
        print("partial run (--only replica): no result line")
        return 0
    if opts.only == "kubelet":
        kubelet_phase(smi)
        print("partial run (--only kubelet): no result line")
        return 0
    if opts.only == "cluster":
        cluster_phase(smi)
        print("partial run (--only cluster): no result line")
        return 0

    with Phase("3 kernel vs plain version"):
        # (P, N, seed, options): random cases, ragged P and N, identical
        # nodes (every cell ties: prune + first index decide) with uniform
        # and with mixed pods, dead pod tiles (a tail's shape, also at the
        # tail's P against many slices), R at both ends
        for P, N, seed, kw in [
                (2048, 5632, 1, {}), (2047, 5631, 2, {}), (130, 520, 3, {}),
                (67, 2053, 5, {}),
                (4096, 3000, 6, {"identical": True, "same_pods": True}),
                (1000, 3000, 7, {"identical": True}),
                (5000, 4000, 8, {"dead_tiles": True}),
                (512, 20000, 9, {"dead_tiles": True}),
                (300, 1000, 10, {"R": 2}), (300, 1000, 11, {"R": 16})]:
            args = random_claims_case(P, N, seed, dev, **kw)
            for noise in kernels.NOISE_KINDS:
                check_claims(kernels, args, noise, f"{P}x{N} {kw or ''}")
        args = random_claims_case(9, 130, 4, dev)
        nothing = ({**args[0], "smask_t": torch.zeros_like(args[0]["smask_t"])},
                   *args[1:])
        for noise in kernels.NOISE_KINDS:
            got, _ = kernels.claims(*nothing, noise=noise)
            check(bool((got == -1).all()), "nothing feasible: a pod claimed")
            check_claims(kernels, nothing, noise, "nothing-feasible")
        args = random_claims_case(2048, 5632, 1, dev)
        for noise in kernels.NOISE_KINDS:
            ms = time_cuda(lambda: kernels.claims(*args, noise=noise), 20)
            print(f"   2048x5632 {noise}: {ms:.4f} ms/launch (median of 20) "
                  f"[{smi}]", flush=True)

    with Phase("4 slice GPU vs CPU"):
        # murmur is integer noise; the sin noise is f64 sin rounded to f32
        # on both devices, so both must agree bit for bit
        kept, by_noise = [], {}
        for noise in ("murmur", "sin"):
            runs = by_noise[noise] = {}
            for device in (dev, torch.device("cpu")):
                with ClaimsRecorder(kernels, keep=True) as rec, \
                        PlaneRecorder(kernels) as planes:
                    label = f"slice-{device.type}-{noise}"
                    backend, _outs, _secs, waves = drive(
                        build_cluster(5000, 7), make_batches(2, 4096, label),
                        device, label, 4096, claims_noise=noise)
                rec.planes = planes
                if device.type == "cuda":
                    kept += rec.inputs
                state, _ = carry.state_to_numpy(backend._state)
                runs[device.type] = (
                    [r.get().copy() for r in backend.results], state, waves,
                    rec)
        # the launches first: should the vectors below differ, this says
        # whether a launch or only the noise's inputs did
        replay_launches(kernels, kept, "slice-cuda")
        del kept
        for noise, runs in by_noise.items():
            g, c = runs["cuda"], runs["cpu"]
            agree = len(g[0]) == len(c[0]) and all(
                np.array_equal(a, b) for a, b in zip(g[0], c[0]))
            if not agree:
                print(f"   {noise}: waves per batch GPU {g[2]} CPU {c[2]}",
                      flush=True)
                explain_divergence(kernels, g[3], c[3])
                c[3].planes.explain(c[3])
            check(agree,
                f"{noise}: GPU and CPU result vectors differ: " + "; ".join(
                    f"vector {i} slots {d[:8].tolist()} GPU {a[d[:8]].tolist()}"
                    f" CPU {b[d[:8]].tolist()}"
                    for i, (a, b) in enumerate(zip(g[0], c[0]))
                    for d in [np.nonzero(a != b)[0]] if d.size))
            for k in state:
                check(np.array_equal(g[1][k], c[1][k]),
                      f"{noise}: final state {k} differs")
            print(f"   {noise}: {len(g[0])} result vectors and the final "
                  f"state are bit-identical; waves per batch {g[2]}",
                  flush=True)
        del by_noise
    if opts.until == "4":
        print("partial run (--until 4): no result line")
        return 0

    summaries = {}
    for label, n_nodes, n_batches in (("5k", 5000, 3), ("100k", 100_000, 12)):
        with Phase(f"{'5' if label == '5k' else '6'} SchedulingBasic "
                   f"{n_nodes} nodes"):
            kernels.LAUNCHES["claims"] = 0
            torch.cuda.reset_peak_memory_stats()
            with ClaimsRecorder(kernels) as rec:
                cache = build_cluster(n_nodes, 1)
                backend, outs, secs, waves = drive(
                    cache, make_batches(n_batches, 16384, f"{label}1"), dev,
                    label, 16384, claims_noise="sin")
            launches = kernels.LAUNCHES["claims"]
            by_shape = rec.summary(label, smi)
            check(sum(c for c, _ms in by_shape.values()) == launches,
                  f"{label}: recorded launches differ from the count")
            check(launches > 0, f"{label}: the claims kernel never launched")
            verify_placements(cache, outs, n_batches * 16384, label)
            step_ms = backend.step_ms()
            rate = n_batches * 16384 / sum(secs)
            print(f"   {label}: batch wall ms p50 "
                  f"{statistics.median(secs) * 1e3:.3f} max "
                  f"{max(secs) * 1e3:.3f} (every pod of a batch waits for "
                  f"the whole batch)", flush=True)
            print(f"   {label}: {rate:.1f} pods/s over {n_batches} batches "
                  f"(batch wall s {[round(s, 4) for s in secs]}); waves per "
                  f"batch {waves}; step span on the CUDA stream ms "
                  f"{[round(x, 3) for x in step_ms]}; claims launches "
                  f"{launches}; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"[{smi}]", flush=True)
            # host/device split per batch
            enc = [round(x * 1e3, 3) for x in backend.encode_s]
            stw = [round(x * 1e3, 3) for x in backend.step_wall_s]
            rest = [round(w * 1e3 - e - t, 3)
                    for w, e, t in zip(secs, enc, stw)]
            print(f"   {label}: per batch ms: encode {enc}; device step "
                  f"(host wall, waits for each wave's count) {stw}; rest "
                  f"(sync, pack, decode, replay) {rest}", flush=True)
            profile_batch(backend, cache, label, smi)
            summaries[label] = (backend, launches, by_shape)

    with Phase("7 claims at the main path's launch shapes"):
        backend, launches, by_shape = summaries["100k"]
        after = backend._state
        empty = {k: torch.zeros_like(after[k])
                 for k in ("used", "used_nz", "npods")}
        # the tail's pods keep their original batch positions as noise keys
        tail_ids = torch.arange(512, dtype=torch.int32, device=dev) * 32
        errs, timed = [], {}
        for shape, P, noise, ids, mixed in (
                ("wave", 16384, "sin", None, False),
                ("wave mixed", 16384, "sin", None, True),
                ("tail", 512, "murmur", tail_ids, False)):
            for state_name, state in (("empty cluster", empty),
                                      ("after the 100k run", after)):
                args, raw = wave_shape_args(backend, P, state, dev, mixed)
                label = f"{shape} {P}x{args[0]['shape'][1]}, {state_name}"
                err, *answer = check_claims(kernels, args, noise, label, ids)
                errs.append(err)
                first = [t.clone() for t in kernels.claims(
                    *args, noise=noise, pod_ids=ids)]
                for _ in range(5):
                    again = kernels.claims(*args, noise=noise, pod_ids=ids)
                    check(all(bool(torch.equal(g, f))
                              for g, f in zip(again, first)),
                          f"{label}: a launch differs from the first")
                ms = time_cuda(lambda: kernels.claims(
                    *args, noise=noise, pod_ids=ids), 20)
                b = claims_bounds(args, noise, answer)
                n = b["cells"]
                print(f"   {label} {noise}: {ms:.4f} ms/launch; bound "
                      f"{b['required'][0]:.4f} ms ({b['required'][1]}) with "
                      f"the noise on the required cells, "
                      f"{b['candidates'][0]:.4f} ms ({b['candidates'][1]}) "
                      f"on the candidate cells, "
                      f"{b['first revision'][0]:.4f} ms "
                      f"({b['first revision'][1]}) by the first kernel "
                      f"revision's definition; cells live "
                      f"{n['live']} feasible {n['feasible']} candidates "
                      f"{n['candidates']} required {n['required']}; "
                      f"request-node pairs {n['pairs']} ({n['pairs fit']} "
                      f"fit) [{smi}]", flush=True)
                timed[(shape, state_name)] = (ms, b, args)
                if others:
                    time_in_turns(kernels, others, args, raw, noise, ids,
                                  label, smi)
        ms, bounds, args = timed[("wave", "after the 100k run")]
        plain_ms = time_cuda(
            lambda: kernels.claims_reference(*args, noise="sin"), 3, warmup=1)
        print(f"   wave plain version {plain_ms:.4f} ms [{smi}]", flush=True)
        # the wave's inputs with the integer noise: what the sin costs
        errs.append(check_claims(kernels, args, "murmur", "wave murmur")[0])
        ms_m = time_cuda(lambda: kernels.claims(*args, noise="murmur"), 20)
        print(f"   wave 16384 murmur, after the 100k run: {ms_m:.4f} "
              f"ms/launch [{smi}]", flush=True)
        bound_ms, bound_by = bounds["required"]

    # the full (constraint) variant's path
    del summaries, timed, args, raw, after, empty, backend
    torch.cuda.empty_cache()
    full_variant_phases(dev, smi)

    # batched preemption: the dry-run kernel, then preempt_batch at 100k
    dry_run_phase(dev, smi, others_preempt)
    pre = preempt_phase(dev, smi, others=others_preempt)

    # the scheduler loop above BatchBackend
    loop_launches, rows = loop_phases(smi)
    # checkpoint / warm start
    warm_start_phase(dev, smi)
    # observability: spans, the wave timeline, the census, the sanitizers
    observability_phase(dev, smi)
    # the device worker seam: a worker process on the card, the seam rows
    seam_launches = seam_phases(dev, smi, rows)
    # the multi-device sharded path
    shard_launches, shard_err, _offset_ms = sharded_phases(dev, smi, rows)
    # the snapshot API, the strict scan and the entry points
    k10, dry_launches = snapshot_phases(dev, smi)
    # the front door: the apiserver and its HTTP client
    http_launches = front_door_phase(smi)
    # in-process scale-out: N Schedulers over one store on this card
    scaleout_launches, scaleout_err = scaleout_phase(smi)
    # the scheduler's binary: two processes behind the apiserver process
    binary_launches = binary_phase(smi)
    # process-true scale-out: N scheduler processes on this card
    proc_launches, proc_err = proc_phase(smi)
    # store replication: a scheduler failing over to a promoted follower
    replica_launches, replica_err = replica_phase(smi)
    # the node agent: hollow nodes running the pods the binary binds
    kubelet_launches = kubelet_phase(smi)
    # the all-in-one cluster: a Deployment rolled out, updated and deleted
    cluster_launches, cluster_err = cluster_phase(smi)

    print(f"total wall {time.monotonic() - t_all:.3f} s")
    # K10 has no hand kernel: its numbers ride a line of their own
    print(json.dumps({"torch_programs": [{
        **k10, "replaces": "kubernetes_tpu/models/assign.py:794",
        "source": "kubernetes_tpu_torch/models/assign.py _scan_pods"}]}))
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "claims", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/claims.cu",
        "replaces": "kubernetes_tpu/ops/pallas_kernels.py:171",
        "launches": (launches + loop_launches["Scheduling100k"]["claims"]
                     + sum(seam_launches[name]["claims"]
                           for name in SEAM_LOOP_ROWS)
                     + shard_launches + dry_launches
                     + sum(http_launches.values()) + scaleout_launches
                     + binary_launches + proc_launches + replica_launches
                     + kubelet_launches + cluster_launches),
        "max_abs_err": max(errs + [shard_err, scaleout_err, proc_err,
                                   replica_err, cluster_err]),
        "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}, {
        "name": "preempt_dry_run", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/preempt.cu",
        "replaces": "kubernetes_tpu/models/preempt.py:124",
        "launches": (pre["launches"]
                     + loop_launches["PreemptionBasic"]["preempt"]
                     + loop_launches["PreemptionDense"]["preempt"]
                     + seam_launches["PreemptionBasic"]["preempt"]),
        "max_abs_err": pre["max_abs_err"], "ms": pre["ms"],
        "launch_ms": pre["launch_ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

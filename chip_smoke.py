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
 10. SchedulingBasicPaced, the latency row (5,000 nodes, 24,000 pods
     arriving at 8,000 pods/s, batch 512, depth 12, 1 ms admission).
     8-10 each print the bench row (pods/s, pod e2e p50/p95/p99 ms), check
     from the store that every created pod is bound and no node holds more
     than its CPU, memory or 110 pods, and check no ERROR status, a zero
     escape rate and claims launches; then print the backend's counters,
     the set-up times outside the window, and one more batch through the
     running loop under torch.profiler (device busy time, idle share).
Phases 5 and 6 are the plain main path through TorchBatchBackend.assign,
8-10 the same path under the scheduler loop, (a)-(d) the full variant's:
the kernels' launch counts are zeroed just before each and read just
after; in 5, 6 and 8-10 each kernel must have launched, in (a)-(d) none
(the full variant reaches no hand kernel); every claims launch of 5 and 6
is recorded by shape (pods, live pods, nodes, noise) with its time
between CUDA events.  The last two lines are a JSON line of per-kernel
numbers (its launches: phases 6 and 9) and the device line.  Without a
CUDA device the script exits 2 and prints no result.

--compare TAG=DIR loads the kubernetes_tpu_torch package of another
checkout (e.g. an earlier revision, unpacked with git archive) under its
own name, and times its claims wrapper against this one's in phase 7, in
turns (this, other, other, this) on the same inputs, after checking that
both return the same claims and best.
"""

import argparse
import gc
import importlib
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

H100_HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12      # H100 SXM data sheet, FP32 outside tensor cores
H100_FP64_OPS_PER_S = 34e12      # H100 SXM data sheet, FP64 outside tensor cores
# Operations of one claims call, counted three ways.
#  "PR 1": the first kernel revision's definition: per live cell the mask
#   and cap tests and R compares; per feasible cell the utilizations,
#   score, add and running max (SCORE_OPS) and the noise.
#  "candidates" and "required": the work the inputs need.  Per live cell
#   the mask test; per distinct (pod request, node) pair R compares and
#   the cap test, and where they fit the utilizations and score
#   (PAIR_SCORE_OPS); per noisy cell the noise, add and running max.
#   "candidates" takes the noise on every feasible cell within NOISE_MAX
#   of its pod's best score; "required" only on the cells any exact
#   algorithm must evaluate: those whose upper bound fl(score + NOISE_MAX)
#   lies above the pod's answer, or equals it at a lower node index, and
#   the answer itself.
# The noise: f32 operations (murmur's integer hash counted as 14 of its
# 16), and for sin one f64 sin counted as 20 f64 operations.
FIT_OPS_BASE = 2
SCORE_OPS = 20
MASK_OPS = 1
PAIR_SCORE_OPS = 18
PICK_OPS = 2
NOISE_OPS = {"sin": 12, "murmur": 16}
SIN_F64_OPS = {"sin": 20, "murmur": 0}
# the largest value each noise rule returns (csrc/claims.cu NOISE_MAX)
NOISE_MAX = {"sin": np.float32(1e-3),
             "murmur": np.float32(16777215.0) * np.float32(0.05 / 2**24)}


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
    """Median ms of n launches, each between its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
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


def claims_work(args, noise, answer):
    """Counts of the work one claims call on these inputs needs: live
    cells, feasible cells, distinct (request, node) pairs and those that
    fit, candidate cells (feasible, score within NOISE_MAX of the pod's
    best score) and required cells (see the operation counts above);
    `answer` is the plain version's (claims, best) on the same inputs."""
    from kubernetes_tpu_torch.ops import kernels
    static, active, used, used_nz, npods = args
    P, N, R = static["shape"]
    claim, best = answer
    dev = used.device
    avail = static["alloc"] - used
    cap_ok = npods + 1.0 <= static["maxpods"]
    one = torch.ones((), device=dev)
    nmax = torch.tensor(float(NOISE_MAX[noise]), dtype=torch.float32,
                        device=dev)
    node = torch.arange(N, device=dev)[None, :]

    def fits(req):
        fit = cap_ok[None, :].expand(req.shape[0], N)
        for r in range(R):
            fit = fit & (req[:, r, None] <= avail[None, :, r])
        return fit

    def scores(req_nz):
        utils = []
        for r in range(2):
            a = static["alloc"][None, :, r]
            u = used_nz[None, :, r] + req_nz[:, r, None]
            utils.append(torch.where(
                a > 0, torch.minimum(u / torch.clamp(a, min=1.0), one), one))
        return kernels.fit_score(*utils)

    live = active.bool()
    uniq = torch.unique(torch.cat([static["req"], static["req_nz"]], 1)[live],
                        dim=0)
    n = {"live": int(live.sum()) * N, "pairs": uniq.shape[0] * N,
         "pairs fit": 0, "feasible": 0, "candidates": 0, "required": 0}
    step = max(1, (1 << 25) // N)
    for lo in range(0, uniq.shape[0], step):
        n["pairs fit"] += int(fits(uniq[lo:lo + step, :R]).sum())
    for lo in range(0, P, step):
        hi = min(P, lo + step)
        fit = (fits(static["req"][lo:hi])
               & (static["smask_t"][:, lo:hi].T != 0) & live[lo:hi, None])
        score = scores(static["req_nz"][lo:hi])
        top = torch.where(fit, score, torch.full_like(score, -3e38)).amax(1)
        upper = score + nmax
        b, c = best[lo:hi, None], claim[lo:hi, None]
        n["feasible"] += int(fit.sum())
        n["candidates"] += int((fit & (score + nmax >= top[:, None])).sum())
        n["required"] += int((fit & ((upper > b) | ((upper == b)
                                                     & (node <= c)))).sum())
    return n


def claims_bounds(args, noise, answer):
    """{"PR 1" | "candidates" | "required": (ms, by), "cells": counts} for
    one claims call on these inputs: the larger of the bytes it must move
    (each input read once, each output written once) over HBM bandwidth
    and its operations, counted three ways (above), over the FP32 and
    FP64 peaks."""
    static = args[0]
    P, N, R = static["shape"]
    nbytes = (N * P + 2 * P * R * 4 + P + P * 4 + 3 * N * R * 4 + 2 * N * 4
              + P * 8)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    n = claims_work(args, noise, answer)

    def bound(f32_ops, noisy):
        t_ops = (f32_ops / H100_FP32_OPS_PER_S
                 + noisy * SIN_F64_OPS[noise] / H100_FP64_OPS_PER_S) * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                               "bytes")
    out = {"PR 1": bound(n["live"] * (FIT_OPS_BASE + R) + n["feasible"]
                         * (SCORE_OPS + NOISE_OPS[noise]), n["feasible"])}
    needed = (n["live"] * MASK_OPS + n["pairs"] * (R + 1)
              + n["pairs fit"] * PAIR_SCORE_OPS)
    for name in ("candidates", "required"):
        out[name] = bound(needed + n[name] * (NOISE_OPS[noise] + PICK_OPS),
                          n[name])
    out["cells"] = n
    return out


class ClaimsRecorder:
    """Within the block, every kernels.claims call goes through a wrapper
    that records (pods, live pods, nodes, noise) and a pair of CUDA events
    around the call, and with keep=True a copy of its inputs.  The launch
    count stays the package's own (kernels.LAUNCHES)."""

    def __init__(self, kernels, keep=False):
        self.kernels, self.keep, self.rows, self.inputs = kernels, keep, [], []

    def __enter__(self):
        inner = self.inner = self.kernels.claims

        def claims(static, active, used, used_nz, npods, noise="sin",
                   pod_ids=None):
            if self.keep:
                self.inputs.append((
                    {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in static.items()},
                    *(t.clone() for t in (active, used, used_nz, npods)),
                    noise, None if pod_ids is None else pod_ids.clone()))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.monotonic()
            e0.record()
            out = inner(static, active, used, used_nz, npods, noise=noise,
                        pod_ids=pod_ids)
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

            def _device_step(self, variant, staged):
                start = None
                if self.device.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                t0 = time.monotonic()
                res = super()._device_step(variant, staged)
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


# -- the scheduler loop: perf.bench configs through a real Scheduler -------

# phase -> bench config (kubernetes_tpu_torch/perf/bench.py CONFIGS)
LOOP_PHASES = (("8", "SchedulingBasic"), ("9", "Scheduling100k"),
               ("10", "SchedulingBasicPaced"))


def profile_loop_batch(cluster, batch, label, smi, top=8):
    """One more batch of SchedulingBasic pods through the running
    Scheduler (after the measured window and the launch count were read)
    under torch.profiler: wall from the create to the last bind, device
    busy time of the kernels and copies in it, and the device's idle
    share.  The loop's threads launch the kernels; CUPTI records every
    launch of the process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.client.clientset import PODS
    from kubernetes_tpu_torch.perf.scheduler_perf import _default_pod
    sched = cluster.scheduler
    backend = sched.profiles["default-scheduler"].batch_backend
    op = {"podNamePrefix": f"prof-{label}-"}
    pods = [_default_pod(i, op) for i in range(batch)]

    def scheduled():
        with sched.metrics.lock:
            return sched.metrics.schedule_attempts.get("scheduled", 0)

    base, w0 = scheduled(), backend.stats["waves"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        cluster.client.create_bulk(PODS, pods)
        deadline = t0 + 120.0
        while scheduled() < base + batch and time.monotonic() < deadline:
            time.sleep(0.002)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    check(scheduled() >= base + batch,
          f"{label}: the profiled batch did not bind within 120 s")
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"   {label} profiled loop batch ({batch} pods, create to last "
          f"bind): wall {wall_ms:.3f} ms, {backend.stats['waves'] - w0} "
          f"waves, {sum(r[1] for r in rows)} device events, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f} [{smi}]",
          flush=True)
    for ms, count, key in rows[:top]:
        print(f"     {ms:10.3f} ms  x{count:<5d} {key[:90]}")


def loop_phases(smi):
    """Phases 8-10: the bench configs through perf.bench.run_config on the
    card (store, informers, queue, Scheduler, TorchBatchBackend, binder).
    The claims count is zeroed before each and read when the workload is
    done; the checks read the store, not the backend.  Returns
    {config: claims launches}."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.perf import bench
    launches = {}
    for num, name in LOOP_PHASES:
        with Phase(f"{num} {name} through the Scheduler"):
            gc.collect()
            torch.cuda.empty_cache()
            kernels.LAUNCHES["claims"] = 0
            cfg = bench.CONFIGS[name]

            def after(cluster, name=name, cfg=cfg):
                launches[name] = kernels.LAUNCHES["claims"]
                profile_loop_batch(cluster, cfg["batch"], name, smi)

            row, res = bench.run_config(name, after=after)
            print(json.dumps(row), flush=True)
            print(f"   {name} row measured on [{smi}]", flush=True)
            check("error" not in res, f"{name}: {res.get('error')}")
            check(res["stats"].get("barrier_ok"), f"{name}: barrier failed")
            d = row["detail"]
            placed = d["placements"]
            print(f"   {name}: placements from the store {placed}",
                  flush=True)
            # the store also holds the profiled batch's pods
            check(placed["bound"] == placed["pods"]
                  == res["stats"]["created_pods"] + cfg["batch"],
                  f"{name}: {placed['bound']} of {placed['pods']} pods bound "
                  f"({res['stats']['created_pods']} created, "
                  f"{cfg['batch']} profiled)")
            check(placed["nodes_over_capacity"] == 0
                  and placed["max_pods_per_node"] <= 110,
                  f"{name}: nodes over capacity {placed['over_examples']}")
            check(d["schedule_attempts"]["error"] == 0,
                  f"{name}: ERROR statuses {d['schedule_attempts']}")
            check(d.get("escape_rate") == 0.0,
                  f"{name}: escape_rate {d.get('escape_rate')}")
            check(launches.get(name, 0) > 0,
                  f"{name}: the claims kernel never launched")
            st = res["stats"]["backend_stats"]
            print(f"   {name}: claims launches {launches[name]}; backend "
                  f"batches {st['batches']} waves {st['waves']} flush_first "
                  f"{st['flush_first']} waves_patched {st['waves_patched']} "
                  f"full_refresh {st['full_refresh']}; outside the window: "
                  f"setup {d['setup_s']} s, node creation "
                  f"{d['create_nodes_s']} s, flatten "
                  f"{d['flatten_before_window_s']} s [{smi}]", flush=True)
    return launches


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="TAG=DIR",
                    help="a checkout of another revision whose claims "
                         "wrapper to time beside this one's")
    return ap.parse_args(argv)


def load_revision(tag, root):
    """The ops.kernels module of the kubernetes_tpu_torch package under
    `root`, imported as a package of its own (kubernetes_tpu_torch_<tag>),
    so that its claims wrapper builds and launches its own kernel."""
    pkg = Path(root).resolve() / "kubernetes_tpu_torch"
    name = f"kubernetes_tpu_torch_{tag}"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.kernels")


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
    opts = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
              f"{importlib.util.find_spec('yaml') is not None}", flush=True)

    with Phase("2 kernel build"):
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
                # the main path's instantiations: R=6 (and the fold)
                tpl = re.search(r"slice_kernelILi(\d+)ELi(\d+)ELb(\d)", entry)
                what = ("fold" if "fold_kernel" in entry else tpl and
                        f"slice R={tpl[1]} pods/thread={tpl[2]} "
                        f"{'murmur' if tpl[3] == '1' else 'sin'}")
                if ("registers" in line or "spill" in line) and what and (
                        what == "fold" or tpl[1] == "6"):
                    print(f"     {what}: {line.strip()}")
        print(f"   build {time.monotonic() - t0:.3f} s [{smi}]", flush=True)
        others = {tag: load_revision(tag, root) for tag, root in
                  (spec.split("=", 1) for spec in opts.compare)}
        t0 = time.monotonic()
        with ThreadPoolExecutor() as pool:   # one nvcc process each
            list(pool.map(lambda k: k._kernel_lib(), others.values()))
        if others:
            print(f"   built {sorted(others)} in "
                  f"{time.monotonic() - t0:.3f} s", flush=True)

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
        kept = []
        for noise in ("murmur", "sin"):
            runs = {}
            for device in (dev, torch.device("cpu")):
                with ClaimsRecorder(kernels, keep=device.type == "cuda") \
                        as rec:
                    label = f"slice-{device.type}-{noise}"
                    backend, _outs, _secs, waves = drive(
                        build_cluster(5000, 7), make_batches(2, 4096, label),
                        device, label, 4096, claims_noise=noise)
                kept += rec.inputs
                state, _ = carry.state_to_numpy(backend._state)
                runs[device.type] = (
                    [r.get().copy() for r in backend.results], state, waves)
            g, c = runs["cuda"], runs["cpu"]
            check(len(g[0]) == len(c[0]) and all(
                np.array_equal(a, b) for a, b in zip(g[0], c[0])),
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
        replay_launches(kernels, kept, "slice-cuda")
        del kept

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
                      f"on the candidate cells, {b['PR 1'][0]:.4f} ms "
                      f"({b['PR 1'][1]}) by PR 1's definition; cells live "
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

    # the scheduler loop above BatchBackend
    loop_launches = loop_phases(smi)

    print(f"total wall {time.monotonic() - t_all:.3f} s")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "claims", "route": "cuda",
        "source": "kubernetes_tpu_torch/ops/csrc/claims.cu",
        "replaces": "kubernetes_tpu/ops/pallas_kernels.py:171",
        "launches": launches + loop_launches["Scheduling100k"],
        "max_abs_err": max(errs), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""kubernetes_tpu_torch on the card: the CUDA kernels (claims, the
preemption dry run) against their plain versions, and the GPU steps (plain
and full), backend, batched preemption and scheduler loop against the CPU
ones.  Imports
neither jax nor kubernetes_tpu, so it runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every case skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.models import assign, preempt
from kubernetes_tpu_torch.ops import kernels
from torch_cases import (
    CANDIDATE_CASES, CAPS, CLAIMS_CASES, DRY_RUN_CASES, FULL_CASES, K_CAP,
    PORT_PKG, SEQ_BATCH, SEQ_CAPS, STEP_CASES, candidates_case,
    dry_run_case, dry_run_inputs, make_full_case, make_step_case,
    pipelined_run, port_side, port_tensors, run_claims, run_port_full_step,
    run_port_step, sequence, snapshot_node, step_patches,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("noise", kernels.NOISE_KINDS)
@pytest.mark.parametrize("case", sorted(CLAIMS_CASES))
def test_kernel_matches_plain_version(cuda, case, noise):
    """murmur: bit for bit.  sin: both sides take the correctly rounded f32
    sin through f64 and agree in practice, but two f64 sin implementations
    can round to different f32 values in rare cells, so the tolerance rule
    of test_torch_kernels.py is what is held."""
    c = CLAIMS_CASES[case]()
    before = kernels.LAUNCHES["claims"]
    got, best = run_claims(c, noise, device=cuda)
    assert kernels.LAUNCHES["claims"] == before + 1
    want, want_best = run_claims(c, noise, device=cuda,
                                 fn=kernels.claims_reference)
    if noise == "murmur":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(best, want_best)
    else:
        np.testing.assert_array_equal(got == -1, want == -1)
        np.testing.assert_allclose(best, want_best, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", sorted(CLAIMS_CASES))
def test_kernel_at_a_node_offset_matches_plain_version(cuda, case):
    """One shard's launch: the nodes from N/3 on at node_offset N/3, the
    murmur noise keyed on the global node, bit for bit against the plain
    version at the same offset."""
    c = CLAIMS_CASES[case]()
    N = c["alloc"].shape[0]
    lo = N // 3
    before = kernels.LAUNCHES["claims"]
    got, best = run_claims(c, "murmur", device=cuda, nodes=slice(lo, N),
                           node_offset=lo)
    assert kernels.LAUNCHES["claims"] == before + 1
    want, want_best = run_claims(c, "murmur", device=cuda,
                                 fn=kernels.claims_reference,
                                 nodes=slice(lo, N), node_offset=lo)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(best, want_best)


@pytest.mark.parametrize("features", ["plain", "full"])
def test_sharded_step_on_the_card_equals_cpu(cuda, features):
    """Four shards of one card against four CPU shards."""
    from kubernetes_tpu_torch.parallel import mesh
    if features == "plain":
        caps, state, static, b = make_step_case(256, 700, False, 4)
        spec = assign.PackSpec(caps, 700, K_CAP, plain=True)
        buf = assign.pack_pod_batch(b, spec, *step_patches(caps))
        feats, P = assign.PLAIN_FEATURES, 700
    else:
        caps, state, static, batch, patches = make_full_case("mixed_patched")
        P = batch.p_cap
        buf = assign.pack_pod_batch(batch, assign.PackSpec(caps, P, K_CAP),
                                    *patches)
        feats = assign.ALL_FEATURES
    out = []
    for dev in ("cpu", cuda):
        m = mesh.make_mesh(dev, shards=4)
        step = mesh.build_sharded_step_fn(caps, m, P, k_cap=K_CAP,
                                          features=feats)
        placed = mesh.split_arrays({**state, **static}, m)
        st = {k: placed[k] for k in mesh.STATE_KEYS}
        st, a, w, g = step(st, {k: placed[k] for k in static},
                           torch.from_numpy(buf).to(m.home))
        got = mesh.gather_arrays({k: st[k] for k in mesh.AGGREGATE_KEYS})
        got.update(assignments=a.cpu().numpy(), waves=int(w), gen=int(g))
        out.append(got)
    for k, v in out[0].items():
        np.testing.assert_array_equal(out[1][k], v, err_msg=k)


@pytest.mark.parametrize("noise", kernels.NOISE_KINDS)
@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_step_matches_cpu_step(cuda, name, noise):
    """The card's step equals the CPU's bit for bit, result vector and
    every state array: murmur is integer noise, and the sin noise is the
    correctly rounded f32 sin on both."""
    n_cap, p_cap, identical, seed, with_patches = STEP_CASES[name]
    caps, state, static, b = make_step_case(n_cap, p_cap, identical, seed)
    rows, vals = step_patches(caps) if with_patches else (None, None)
    spec = assign.PackSpec(caps, p_cap, K_CAP, plain=True)
    buf = assign.pack_pod_batch(b, spec, rows, vals)
    cst, cres = run_port_step(caps, p_cap, state, static, buf, noise)
    gst, gres = run_port_step(caps, p_cap, state, static, buf, noise, cuda)
    np.testing.assert_array_equal(gres, cres)
    for k in assign.STATE_KEYS:
        np.testing.assert_array_equal(gst[k], cst[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(FULL_CASES))
def test_full_step_matches_cpu_step(cuda, name):
    """The full (constraint) step on the card equals the CPU's bit for
    bit: result vector and every state array."""
    caps, state, static, batch, patches = make_full_case(name)
    rows, vals = patches if patches else (None, None)
    spec = assign.PackSpec(caps, batch.p_cap, K_CAP)
    buf = assign.pack_pod_batch(batch, spec, rows, vals)
    cst, cres = run_port_full_step(caps, batch.p_cap, state, static, buf)
    gst, gres = run_port_full_step(caps, batch.p_cap, state, static, buf,
                                   cuda)
    np.testing.assert_array_equal(gres, cres)
    for k in assign.STATE_KEYS:
        np.testing.assert_array_equal(gst[k], cst[k], err_msg=k)


@pytest.mark.parametrize("name", ["every_kind", "every_kind_tail"])
@pytest.mark.parametrize("mode", ["scan", "wave"])
def test_snapshot_on_the_card_equals_cpu(cuda, mode, name):
    """The snapshot form at 5,000 nodes (every constraint kind, ports,
    pins, PreferNoSchedule taints, namespaceSelector terms): the scan and
    the wave on the card equal themselves on the CPU, every output key
    bit for bit."""
    caps, state, static, batch, _p = make_full_case(name, n_nodes=5000)
    node = snapshot_node(state, static)
    got = assign.build_assign_fn(caps, mode=mode, device=cuda)(node, batch)
    want = assign.build_assign_fn(caps, mode=mode, device="cpu")(node, batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert (want["assignments"] >= 0).any()


def test_backend_matches_cpu_backend(cuda):
    """The pipelined patch / static-patch / refresh sequence gives the same
    (node, status) lists on the card as on the CPU."""
    on_gpu, gpu_stats = sequence(port_side(SEQ_BATCH, SEQ_CAPS, cuda), 2)
    on_cpu, _ = sequence(port_side(SEQ_BATCH, SEQ_CAPS, "cpu"), 2)
    assert on_gpu == on_cpu
    assert gpu_stats.get("fence_replays", 0) == 1


def test_wrapper_rejects_misaligned_mask(cuda):
    """The kernel reads each node row's pod bytes with aligned vector
    loads: a mask that does not start 16-byte aligned is refused, not
    read."""
    c = CLAIMS_CASES["130x520"]()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    static = kernels.prepare_static(t(c["req"]), t(c["req_nz"]), t(c["alloc"]),
                                    t(c["maxpods"]), t(c["smask"].T))
    mask = static["smask_t"]
    shifted = torch.empty(mask.numel() + 1, dtype=torch.uint8,
                          device=cuda)[1:].view(mask.shape)
    shifted.copy_(mask)
    with pytest.raises(ValueError, match="aligned"):
        kernels.claims({**static, "smask_t": shifted}, t(c["active"]),
                       t(c["used"]), t(c["used_nz"]), t(c["npods"]))


def test_loop_on_the_card_with_a_wave_deadline_equals_cpu(cuda):
    """The scheduler loop stepped at depth 2 (a FLUSH_FIRST re-dispatch and
    a node event patch in between) with the stuck-wave watchdog armed, so
    every resolve() runs on a wave-resolve thread against the card: the
    same placements as the loop on the CPU."""
    cpu_out, _stats, _threads = pipelined_run(PORT_PKG)
    out, stats, threads = pipelined_run(PORT_PKG, deadline=60.0,
                                        device="cuda")
    assert out == cpu_out
    assert threads == {"wave-resolve"}
    assert stats["flush_first"] >= 1 and stats["event_patches"] >= 1


@pytest.mark.parametrize("case", sorted(DRY_RUN_CASES))
def test_dry_run_kernel_matches_plain_version(cuda, case):
    """csrc/preempt.cu against preempt_dry_run_reference on the same card
    inputs: all seven outputs bit for bit (the kernel sums in the plain
    version's order and contracts nothing), one launch counted."""
    t = port_tensors(dry_run_inputs(case), cuda)
    before = kernels.LAUNCHES["preempt"]
    got = preempt.preempt_dry_run(*t)
    assert kernels.LAUNCHES["preempt"] == before + 1
    want = preempt.preempt_dry_run_reference(*t)
    for name, g, w in zip(("cand", "viol", "highest", "psum", "nvic",
                           "victims", "overflow_hit"), got, want):
        assert g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("case", sorted(DRY_RUN_CASES))
def test_dry_run_kernel_at_any_live_cap(cuda, case):
    """The planes depend neither on the shared-memory size nor on the grid:
    k_cap from the data (live_slot_cap), the wrapper's default and k_cap =
    V agree bit for bit, one bare launch through prepared_launch counts
    once and fills the same planes, and so do blocks that walk all pods,
    64 or 7."""
    t = port_tensors(dry_run_inputs(case), cuda)
    V = t[6].shape[1]
    cap = preempt.live_slot_cap(t[6])
    first = preempt.dry_run_planes(*t)
    for k in (cap, V):
        got = preempt.dry_run_planes(*t, k_cap=k)
        assert all(torch.equal(g, f) for g, f in zip(got, first)), k
    launch, planes = preempt.prepared_launch(*t, k_cap=cap)
    before = kernels.LAUNCHES["preempt"]
    launch()
    assert kernels.LAUNCHES["preempt"] == before + 1
    assert all(torch.equal(g, f) for g, f in zip(planes, first))
    # either grid (all pods a block, or 64- and 7-pod ranges)
    for ppb in (len(t[14]), 64, 7):
        launch, planes = preempt.prepared_launch(*t, k_cap=cap,
                                                 pods_per_block=ppb)
        launch()
        assert all(torch.equal(g, f) for g, f in zip(planes, first)), ppb
    occ = preempt.kernel_occupancy(t[0].shape[1], t[5].shape[1], cap)
    assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0


def test_dry_run_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = port_tensors(dry_run_inputs("3x130_r2"), cuda)
    with pytest.raises(ValueError, match="req"):
        preempt.preempt_dry_run(*t[:13], t[13].double(), *t[14:])
    wide = port_tensors(dry_run_case(3, 40, 33, 2, 1, 1, 9), cuda)
    with pytest.raises(ValueError, match="V=33"):
        preempt.preempt_dry_run(*wide)


@pytest.mark.parametrize("case", sorted(CANDIDATE_CASES))
def test_candidates_on_the_card_equal_cpu(cuda, case):
    """K8 (torch) on the card: the same rows, ties included, and counts."""
    *shape, k = CANDIDATE_CASES[case]
    args = candidates_case(*shape)
    rows, count = preempt.preempt_candidates(*port_tensors(args, cuda), k)
    want_rows, want_count = preempt.preempt_candidates(*port_tensors(args),
                                                       k)
    assert torch.equal(rows.cpu(), want_rows)
    assert torch.equal(count.cpu(), want_count)


def test_preempt_batch_on_the_card_equals_cpu(cuda):
    """A seeded cluster of low-priority residents and a wave of
    preemptors: TorchBatchBackend.preempt_batch on the card gives the CPU
    backend's nodes, victims, violations and wave order."""
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    outs = []
    for device in (cuda, "cpu"):
        s = port_side(8, dict(CAPS, n_cap=64), device)
        rng = np.random.default_rng(17)
        for i in range(40):
            s.cache.add_node(s.node(f"n{i}", cpu=str(int(rng.integers(1, 5))),
                                    mem="32Gi"))
        for i in range(120):
            s.cache.add_pod(s.testing.make_pod(f"v{i}")
                            .priority(int(rng.integers(0, 5)))
                            .req(cpu=f"{int(rng.integers(1, 9)) * 100}m")
                            .node(f"n{int(rng.integers(0, 40))}").build())
        snap = s.snapshot()
        s.backend.assign([], snap)
        s.backend.warmup()
        pre = [PodInfo(s.testing.make_pod(f"p{j}")
                       .priority(int(rng.choice([5, 10, 20])))
                       .req(cpu=f"{int(rng.integers(5, 36)) * 100}m").build())
               for j in range(30)]
        before = kernels.LAUNCHES["preempt"]
        res, esc = s.backend.preempt_batch(
            pre, {ni.name: i for i, ni in enumerate(snap.list())})
        launched = kernels.LAUNCHES["preempt"] - before
        outs.append(([None if r is None else (r[0], sorted(r[1]), r[2])
                      for r in res], esc, list(s.backend.last_wave_order)))
        if device == cuda:
            assert launched == 1
    assert outs[0] == outs[1]
    assert sum(1 for r in outs[0][0] if r) >= 5


# -- observability on the card ----------------------------------------------

def _loaded_card_side(cuda, batch=SEQ_BATCH):
    s = port_side(batch, SEQ_CAPS, device=cuda)
    rng = np.random.default_rng(3)
    for i in range(20):
        s.cache.add_node(s.node(f"n{i}", cpu=str(int(rng.integers(2, 9))),
                                mem="8Gi"))
    s.backend.warmup()
    return s, rng


def test_sync_guard_allows_only_annotated_sites_on_the_claims_path(cuda):
    """Steady plain waves on the card under SyncGuard("error"): every
    implicit sync is at a `# sync-point:` site (the wave's count reads),
    and the waves still place every pod."""
    from kubernetes_tpu_torch.testing.sanitizers import SyncGuard
    s, rng = _loaded_card_side(cuda)
    waves0 = s.backend.stats["waves"]
    with SyncGuard("error") as g:
        for k in range(5):
            pods = [s.pod(f"p{k}-{i}", cpu="100m", mem="64Mi")
                    for i in range(SEQ_BATCH)]
            s.assume(pods, s.backend.assign(s.infos(pods), s.snapshot()))
    assert g.unannotated() == []
    assert g.syncs >= s.backend.stats["waves"] - waves0


def test_build_counter_reads_zero_after_warmup(cuda):
    from kubernetes_tpu_torch.testing.sanitizers import BuildCounter
    s, _rng = _loaded_card_side(cuda)
    with BuildCounter() as bc:
        for k in range(3):
            pods = [s.pod(f"p{k}-{i}", cpu="100m") for i in range(8)]
            s.assume(pods, s.backend.assign(s.infos(pods), s.snapshot()))
    assert bc.count == 0, (bc.builds, bc.loads)


def test_census_on_the_card(cuda):
    """The census launches the claims kernel in its own tally: LAUNCHES,
    the state and _gen unchanged; device time and the kernel's bytes
    counted; twice the same counts."""
    from kubernetes_tpu_torch.models import carry
    s, _rng = _loaded_card_side(cuda)
    b = s.backend
    state0, _ = carry.state_to_numpy(b._state)
    gen0, launches0 = b._gen, dict(kernels.LAUNCHES)
    a = b.device_census()
    c = b.device_census()
    assert kernels.LAUNCHES == launches0 and b._gen == gen0
    state1, _ = carry.state_to_numpy(b._state)
    assert all(np.array_equal(state0[k], state1[k]) for k in state0)
    k = a["plain"]["kernels"]["claims"]
    assert k["launches"] == a["plain"]["waves"] >= 1
    assert k["device_ms"] > 0 and a["plain"]["device_ms"] >= k["device_ms"]
    assert a["plain"]["cost"]["bytes_accessed"] > k["bytes"] > 0
    strip = {v: {key: val for key, val in rec.items() if key != "device_ms"}
             for v, rec in a.items()}
    for rec in strip.values():
        for kk in rec["kernels"].values():
            kk.pop("device_ms")
    again = {v: {key: val for key, val in rec.items() if key != "device_ms"}
             for v, rec in c.items()}
    for rec in again.values():
        for kk in rec["kernels"].values():
            kk.pop("device_ms")
    assert strip == again


def test_timeline_on_the_card_reads_cuda_events(cuda):
    """The wave's device-step and d2h come from CUDA events mapped onto
    the host clock: d2h inside device-step, and device-step inside the
    host window of dispatch to resolve."""
    import time

    from kubernetes_tpu_torch.component_base import timeline as tlmod
    ring = tlmod.default_timeline
    ring.reset()
    ring.configure(enabled=True)
    try:
        s, _rng = _loaded_card_side(cuda)
        pods = [s.pod(f"p{i}", cpu="100m") for i in range(SEQ_BATCH)]
        t0 = ring.wall(time.monotonic())
        out = s.backend.assign(s.infos(pods), s.snapshot())
        t1 = ring.wall(time.monotonic())
        rows = {r["stage"]: r for r in ring.intervals()}
    finally:
        ring.configure(enabled=False)
        ring.reset()
    assert all(name for name, _st in out)
    dev, d2h = rows["device-step"], rows["d2h"]
    assert t0 - 1e-3 <= dev["t0_unix_s"] <= d2h["t0_unix_s"]
    assert d2h["t1_unix_s"] <= dev["t1_unix_s"] + 1e-6 <= t1 + 1e-3


def test_worker_step_on_the_card_equals_in_process(cuda):
    """A device worker in this process on the card (ops/remote.py
    DeviceWorker): /step's result vector, posted with the bytes an
    in-process TorchBatchBackend on the card steps on, equals that
    backend's bit for bit, batch after batch (the claims kernel runs on
    both sides)."""
    from kubernetes_tpu_torch.ops.remote import (
        DeviceWorker, RemoteTorchBatchBackend,
    )
    s = port_side(SEQ_BATCH, SEQ_CAPS, device=cuda, noise="sin")
    views = {}
    for name in ("local", "remote"):
        # each backend syncs from a cache of its own: a flatten view's
        # change tracking serves one consumer
        c = s.cache_mod.Cache() if name == "remote" else s.cache
        for i in range(20):
            c.add_node(s.node(f"n{i}", cpu="4", mem="8Gi", pods=8))
        views[name] = c.flatten_view()
    worker = DeviceWorker(device=cuda).start()
    try:
        remote = RemoteTorchBatchBackend(
            worker.url, s.backend.caps, batch_size=SEQ_BATCH,
            claims_noise="sin")
        got = {}
        for name, b in (("local", s.backend), ("remote", remote)):
            view = views[name]
            steps = []
            real = b._device_step

            def record(variant, staged, clock=None, real=real, steps=steps):
                res = real(variant, staged, clock)
                steps.append(res.get().copy())
                return res
            b._device_step = record
            b.warmup()
            del steps[:]
            for k in range(3):
                pods = [s.pod(f"w{k}-{i}", cpu="300m", mem="256Mi")
                        for i in range(SEQ_BATCH)]
                b.assign(s.infos(pods), view)
            got[name] = steps
        remote.close()
    finally:
        worker.stop()
    assert len(got["remote"]) == len(got["local"]) == 3
    for r, loc in zip(got["remote"], got["local"]):
        np.testing.assert_array_equal(r, loc)

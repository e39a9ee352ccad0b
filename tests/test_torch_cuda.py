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
    run_port_step, sequence, step_patches,
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

"""kubernetes_tpu_torch on the card: the CUDA kernel against its plain
version, and the GPU steps (plain and full) and backend against the CPU
ones.  Imports
neither jax nor kubernetes_tpu, so it runs on a GPU machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every case skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.models import assign
from kubernetes_tpu_torch.ops import kernels
from torch_cases import (
    CLAIMS_CASES, FULL_CASES, K_CAP, SEQ_BATCH, SEQ_CAPS, STEP_CASES,
    make_full_case, make_step_case, port_side, run_claims,
    run_port_full_step, run_port_step, sequence, step_patches,
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

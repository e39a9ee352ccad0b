"""The port's claims (kubernetes_tpu_torch/ops/kernels.py) against the JAX
package's Pallas claims kernel, run as tests/test_pallas_kernels.py runs
it (interpret mode on the CPU), on that file's shapes and edge cases.

  * noise="murmur": bit-identical claims to the XLA argmax of the same
    [P,N] plane, built from models/assign.py's murmur noise and
    _fit_scores_vec (the reference's KTPU_PALLAS=0 main phase).
  * noise="sin" (the Pallas kernel's own rule): the same pods find no
    node; every pod's claim is, in the Pallas kernel's own scores, within
    1e-4 of its best; and `best` agrees within 1e-4.  f32 sin differs in
    the last bit between implementations and one ulp moves the noise by
    ~2.6e-6, so 1e-4 bounds that with room while staying far below the
    1e-3 noise span.

The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from kubernetes_tpu.models.assign import TIE_NOISE, _fit_scores_vec  # noqa: E402
from kubernetes_tpu.ops.pallas_kernels import (  # noqa: E402
    NEG, claims as jax_claims, prepare_static as jax_prepare_static,
)
from kubernetes_tpu_torch.ops import kernels  # noqa: E402
from torch_cases import (  # noqa: E402
    CLAIMS_CASES, no_feasible_case, random_case, run_claims,
    scalar_gate_case,
)

def run_jax_pallas(c, smask=None):
    smask = c["smask"] if smask is None else smask
    static = jax_prepare_static(jnp.asarray(c["req"]), jnp.asarray(c["req_nz"]),
                                jnp.asarray(c["alloc"]),
                                jnp.asarray(c["maxpods"]), jnp.asarray(smask))
    idx, best = jax_claims(static, jnp.asarray(c["active"]),
                           jnp.asarray(c["used"]), jnp.asarray(c["used_nz"]),
                           jnp.asarray(c["npods"]))
    return np.asarray(idx), np.asarray(best)


def _murmur_noise_jax(P, N):
    """models/assign.py:315-338 at offset 0, materialized on its own as the
    wave does (it is computed once, outside the wave loop)."""
    gn = jnp.arange(N).astype(jnp.uint32)
    pp = jnp.arange(P, dtype=jnp.uint32)
    hx = (pp[:, None] * jnp.uint32(0x9E3779B1)
          ^ gn[None, :] * jnp.uint32(0x85EBCA77))
    hx ^= hx >> 16
    hx *= jnp.uint32(0x85EBCA6B)
    hx ^= hx >> 13
    hx *= jnp.uint32(0xC2B2AE35)
    hx ^= hx >> 16
    return (hx >> 8).astype(jnp.float32) * (TIE_NOISE / (1 << 24))


@jax.jit
def _xla_argmax(req, req_nz, active, alloc, used, used_nz, npods, maxpods,
                smask, noise):
    """The reference's XLA main phase (assign.py:411-490, plain variant)."""
    avail = alloc - used
    fit = (npods + 1.0 <= maxpods)[None, :]
    for r in range(req.shape[1]):
        fit &= req[:, None, r] <= avail[None, :, r]
    feasible = smask & fit & active[:, None]
    least, balanced = _fit_scores_vec(req_nz, alloc, used_nz)
    score = least + balanced
    has = jnp.any(feasible, axis=-1)
    claims = jnp.argmax(jnp.where(feasible, score + noise, NEG), axis=-1)
    return jnp.where(has, claims, -1)


def run_jax_xla_murmur(c):
    P, N = c["smask"].shape
    noise = jax.jit(_murmur_noise_jax, static_argnums=(0, 1))(P, N)
    return np.asarray(_xla_argmax(
        *(jnp.asarray(c[k]) for k in ("req", "req_nz", "active", "alloc",
                                      "used", "used_nz", "npods", "maxpods",
                                      "smask")), noise))


@pytest.mark.parametrize("case", sorted(CLAIMS_CASES))
def test_murmur_bit_identical_to_xla_argmax(case):
    c = CLAIMS_CASES[case]()
    got, _best = run_claims(c, "murmur")
    np.testing.assert_array_equal(got, run_jax_xla_murmur(c))


@pytest.mark.parametrize("case", sorted(CLAIMS_CASES))
def test_sin_matches_pallas_within_tolerance(case):
    c = CLAIMS_CASES[case]()
    got, best = run_claims(c, "sin")
    want, want_best = run_jax_pallas(c)
    np.testing.assert_array_equal(got == -1, want == -1)
    np.testing.assert_allclose(best, want_best, rtol=0, atol=1e-4)
    placed = np.nonzero(got >= 0)[0]
    if placed.size:
        # the Pallas kernel's own noisy score at the port's choice: run it
        # again with every pod's static mask narrowed to that one node
        only = np.zeros_like(c["smask"])
        only[placed, got[placed]] = True
        at_choice, at_best = run_jax_pallas(c, c["smask"] & only)
        np.testing.assert_array_equal(at_choice[placed], got[placed])
        np.testing.assert_allclose(at_best[placed], want_best[placed],
                                   rtol=0, atol=1e-4)


def test_edge_case_answers():
    """The two hand-built cases' known answers (test_pallas_kernels.py)."""
    for noise in kernels.NOISE_KINDS:
        assert (run_claims(no_feasible_case(), noise)[0] == -1).all()
        assert run_claims(scalar_gate_case(), noise)[0][0] == 1


def test_pod_ids_key_the_noise():
    """A sub-batch keyed by its pods' original positions sees exactly the
    noise (so the claims) those pods see in the full batch."""
    c = random_case(130, 520)
    full, _ = run_claims(c, "murmur")
    idx = np.array([3, 17, 64, 99, 128])
    sub = {k: (v[idx] if k in ("req", "req_nz", "active", "smask") else v)
           for k, v in c.items()}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    static = kernels.prepare_static(t(sub["req"]), t(sub["req_nz"]),
                                    t(sub["alloc"]), t(sub["maxpods"]),
                                    t(sub["smask"].T))
    got, _ = kernels.claims(static, t(sub["active"]), t(sub["used"]),
                            t(sub["used_nz"]), t(sub["npods"]),
                            noise="murmur",
                            pod_ids=torch.from_numpy(idx.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), full[idx])


def test_bad_noise_rejected():
    with pytest.raises(ValueError, match="noise"):
        run_claims(random_case(8, 64), "cosine")


@pytest.mark.parametrize("P", [67, 512, 2047])
def test_prepare_static_pads_mask_rows(P):
    """The stored mask's rows are P rounded up to 16 bytes, 16-byte aligned,
    the pad columns 0 (infeasible); the plain version ignores them."""
    c = random_case(P, 40)
    t = torch.from_numpy
    static = kernels.prepare_static(t(c["req"]), t(c["req_nz"]),
                                    t(c["alloc"]), t(c["maxpods"]),
                                    t(np.ascontiguousarray(c["smask"].T)))
    mask = static["smask_t"]
    assert mask.shape == (40, kernels.mask_stride(P))
    assert kernels.mask_stride(P) % 16 == 0 and mask.data_ptr() % 16 == 0
    np.testing.assert_array_equal(mask[:, :P].numpy(), c["smask"].T)
    assert not mask[:, P:].any()
    got, _ = run_claims(c, "murmur")
    np.testing.assert_array_equal(got, run_jax_xla_murmur(c))


# -- the sin noise's sin (ROADMAP Q4) ------------------------------------------

def test_sin_noise_takes_no_library_sin(monkeypatch):
    """The plain version's sin noise is built from IEEE additions and
    multiplications alone (kernels.sin64): a torch.sin that answers
    otherwise (as torch's f64 sin on the H100 machine's CPU did for one
    intra-op thread's chunk, ROADMAP Q4) leaves it unchanged."""
    ids = torch.arange(300, dtype=torch.int32)
    want = kernels.sin_noise(ids, 700)
    monkeypatch.setattr(torch, "sin", lambda x: torch.zeros_like(x))
    assert torch.equal(kernels.sin_noise(ids, 700), want)


def test_sin64_is_the_correctly_rounded_f32_sin():
    """sin64 stays within one f64 ulp of the C library's sin on the noise's
    arguments (f32 values up to 2^24) and on small ones, and rounds to the
    same f32 on every one of them, computed whole or a row at a time."""
    import math
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, 8.8e6, 40000),
                        rng.uniform(-10, 10, 10000),
                        np.arange(0, 20000)]).astype(np.float32)
    x = torch.from_numpy(x.astype(np.float64))
    got = kernels.sin64(x)
    want = torch.tensor([math.sin(v) for v in x.tolist()],
                        dtype=torch.float64)
    eps = torch.finfo(torch.float64).eps
    assert bool(((got - want).abs() <= eps * want.abs()).all())
    assert torch.equal(got.float(), want.float())
    rows = torch.cat([kernels.sin64(r) for r in x.view(100, -1)])
    assert torch.equal(rows, got)


# -- a shard of the node axis (parallel/mesh.py) ----------------------------

def _murmur_noise_jax_at(P, N, offset):
    """models/assign.py:315-338 with the shard's gn = offset + arange."""
    gn = (offset + jnp.arange(N)).astype(jnp.uint32)
    pp = jnp.arange(P, dtype=jnp.uint32)
    hx = (pp[:, None] * jnp.uint32(0x9E3779B1)
          ^ gn[None, :] * jnp.uint32(0x85EBCA77))
    hx ^= hx >> 16
    hx *= jnp.uint32(0x85EBCA6B)
    hx ^= hx >> 13
    hx *= jnp.uint32(0xC2B2AE35)
    hx ^= hx >> 16
    return (hx >> 8).astype(jnp.float32) * (TIE_NOISE / (1 << 24))


@pytest.mark.parametrize("offset", [0, 7, 1000, 110_000])
def test_murmur_noise_at_an_offset_is_the_planes_columns(offset):
    ids = torch.arange(40, dtype=torch.int32)
    got = kernels.murmur_noise(ids, 33, offset).numpy()
    np.testing.assert_array_equal(
        got, kernels.murmur_noise(ids, offset + 33).numpy()[:, offset:])
    np.testing.assert_array_equal(
        got, np.asarray(_murmur_noise_jax_at(40, 33, offset)))


@pytest.mark.parametrize("shards", [2, 3, 5])
@pytest.mark.parametrize("case", ["130x520", "67x2053", "identical_nodes",
                                  "no_feasible", "dead_tiles"])
def test_claims_per_shard_combine_to_the_whole_axis(case, shards):
    """The plain version on each shard's nodes at its offset, combined as
    the sharded step combines them (_Comm.row_argmax: the first shard among
    equal bests), equals the whole axis' claims and best, bit for bit;
    -1 only where no shard has a feasible node."""
    from kubernetes_tpu_torch.models.assign import _Comm
    c = CLAIMS_CASES[case]()
    N = c["alloc"].shape[0]
    want, want_best = run_claims(c, "murmur",
                                 fn=kernels.claims_reference)
    bounds = [N * s // shards for s in range(shards + 1)]
    parts = [run_claims(c, "murmur", fn=kernels.claims_reference,
                        nodes=slice(lo, hi), node_offset=lo)
             for lo, hi in zip(bounds, bounds[1:])]
    # the row_argmax of uneven pieces: shift each local index by its start
    best_all = np.stack([b for _i, b in parts])
    shard = best_all.argmax(0)
    p = np.arange(len(want))
    idx = np.stack([i for i, _b in parts])[shard, p]
    got = np.where(idx >= 0, idx + np.asarray(bounds[:-1])[shard], -1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(best_all[shard, p], want_best)
    if N % shards == 0:
        comm = _Comm(["cpu"] * shards, N // shards)
        j, best = comm.row_argmax([torch.from_numpy(b) for _i, b in parts],
                                  [torch.from_numpy(i) for i, _b in parts])
        has = [torch.from_numpy(np.stack([i for i, _b in parts]) >= 0)
               .any(0)]
        np.testing.assert_array_equal(
            torch.where(has[0], j[0], -1).numpy(), want)


def test_sin_at_a_node_offset_raises():
    c = CLAIMS_CASES["130x520"]()
    with pytest.raises(ValueError, match="node_offset"):
        run_claims(c, "sin", nodes=slice(260, 520), node_offset=260)
    with pytest.raises(ValueError, match="node_offset"):
        run_claims(c, "murmur", nodes=slice(0, 260), node_offset=-1)

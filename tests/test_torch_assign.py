"""Step-level parity: one packed buffer through the JAX package's plain
step (build_packed_assign_fn(features=PLAIN_FEATURES)) and through the
port's (kubernetes_tpu_torch/models/assign.py), from one resident state.

  * KTPU_PALLAS=0 (the reference's XLA main phase, murmur noise) against
    the port at claims_noise="murmur": the int32[p_cap+2] result and every
    state array are bit-identical.
  * The reference at its default (the Pallas kernel in interpret mode, sin
    noise) against the port at "sin": the same pods are placed, no node
    exceeds its capacity or pod cap, and the total usage is the same.

The inputs (tests/torch_cases.py) keep every per-node sum exact in f32.
The card's step is held against the CPU's in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from kubernetes_tpu.models import assign as jax_assign  # noqa: E402
from kubernetes_tpu.ops.flatten import Caps as JaxCaps  # noqa: E402
from kubernetes_tpu_torch.models import assign, carry  # noqa: E402
from kubernetes_tpu_torch.ops.flatten import Caps  # noqa: E402
from torch_cases import (  # noqa: E402
    K_CAP, STEP_CAPS, STEP_CASES, make_full_case, make_step_case,
    run_port_step, step_patches,
)

def run_jax(caps, p_cap, state, static, buf):
    jcaps = JaxCaps(**vars(caps))
    fn, _spec = jax_assign.build_packed_assign_fn(
        jcaps, p_cap, K_CAP, features=jax_assign.PLAIN_FEATURES)
    st, res = fn({k: jnp.asarray(v) for k, v in state.items()},
                 {k: jnp.asarray(v) for k, v in static.items()},
                 jnp.asarray(buf))
    return {k: np.asarray(v) for k, v in st.items()}, np.asarray(res)


def packed(caps, p_cap, b, with_patches):
    spec = assign.PackSpec(caps, p_cap, K_CAP, plain=True)
    rows, vals = step_patches(caps) if with_patches else (None, None)
    buf = assign.pack_pod_batch(b, spec, rows, vals)
    jspec = jax_assign.PackSpec(JaxCaps(**vars(caps)), p_cap, K_CAP,
                                plain=True)
    ref = jax_assign.pack_pod_batch(b, jspec, rows, vals)
    # the wire format is a copy: identical bytes
    np.testing.assert_array_equal(buf.view(np.int32), ref.view(np.int32))
    return buf


@pytest.fixture
def tail_spy(monkeypatch):
    """Counts wave loops run on the compacted TAIL_P sub-batch."""
    calls = []
    real = assign._wave_loop

    def spy(static, state, b, *rest):
        calls.append(b.req.shape[0])
        return real(static, state, b, *rest)

    monkeypatch.setattr(assign, "_wave_loop", spy)
    return calls


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_murmur_step_bit_identical(name, monkeypatch, tail_spy):
    monkeypatch.setenv("KTPU_PALLAS", "0")
    n_cap, p_cap, identical, seed, with_patches = STEP_CASES[name]
    caps, state, static, b = make_step_case(n_cap, p_cap, identical, seed)
    buf = packed(caps, p_cap, b, with_patches)
    jst, jres = run_jax(caps, p_cap, state, static, buf)
    tst, tres = run_port_step(caps, p_cap, state, static, buf, "murmur")
    np.testing.assert_array_equal(tres, jres)
    for k in assign.STATE_KEYS:
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    assert (tres[:-2] >= 0).sum() > 0
    if p_cap > assign.TAIL_P:
        assert assign.TAIL_P in tail_spy, "the compacted tail did not run"


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_sin_step_places_the_same_pods(name):
    n_cap, p_cap, identical, seed, with_patches = STEP_CASES[name]
    caps, state, static, b = make_step_case(n_cap, p_cap, identical, seed)
    buf = packed(caps, p_cap, b, with_patches)
    jst, jres = run_jax(caps, p_cap, state, static, buf)
    tst, tres = run_port_step(caps, p_cap, state, static, buf, "sin")
    np.testing.assert_array_equal(tres[:-2] >= 0, jres[:-2] >= 0)
    np.testing.assert_array_equal(tst["used"].sum(0), jst["used"].sum(0))
    np.testing.assert_array_equal(tst["npods"].sum(), jst["npods"].sum())
    assert (tst["used"] <= static["alloc"]).all()
    assert (tst["npods"] <= static["maxpods"]).all()
    assert tres[-1] == jres[-1] == state["gen"] + 1


def test_carry_round_trip():
    caps, state, static, _b = make_step_case(64, 40, False, 7)
    st, stat = carry.state_from_reference(state, static, "cpu")
    st_np, stat_np = carry.state_to_numpy(st, stat)
    for k in assign.STATE_KEYS:
        np.testing.assert_array_equal(st_np[k], state[k])
    for k in carry.STATIC_CORE:
        np.testing.assert_array_equal(stat_np[k], static[k])
    assert set(stat_np) == set(carry.STATIC_CORE)
    # the selector-side arrays ride along when the static dict holds them
    _c, _s, full_static, _fb, _p = make_full_case("ns_selector")
    _st, fstat = carry.state_from_reference(state, full_static, "cpu")
    _st_np, fstat_np = carry.state_to_numpy(_st, fstat)
    assert set(fstat_np) == set(carry.STATIC_CORE + carry.STATIC_SEL)
    for k in carry.STATIC_CORE + carry.STATIC_SEL:
        np.testing.assert_array_equal(fstat_np[k], full_static[k])
        assert fstat_np[k].dtype == full_static[k].dtype, k
    # the port's in-place updates never write into the caller's arrays
    st["used"] += 1
    assert not np.array_equal(carry.state_to_numpy(st)[0]["used"],
                              state["used"])


def test_tf32_matmuls_refused(monkeypatch):
    """TF32 would round the [P,P] prefix sums of request columns."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        assign.build_packed_assign_fn(Caps(n_cap=64, **STEP_CAPS), 8,
                                      device="cpu")

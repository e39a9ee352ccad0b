"""Step-level parity of the full (constraint) variant: one packed buffer
through the JAX package's build_packed_assign_fn(features=ALL_FEATURES)
and through the port's, from one resident state and one set of static
arrays (tests/torch_cases.py FULL_CASES: seeded clusters and constraint
batches encoded by the port's flatten copy).

Both sides use the murmur noise, so the tolerance is exact: the
int32[p_cap+2] result (assignments, wave count, generation) and every
state array (used, used_nz, npods, port_mask, cd_sg, cd_asg) must be
bit-identical.  The hard-spread case has P > TAIL_P, so the JAX step runs
its spread cohort and its compacted tail.  The JAX steps are compiled once
per (caps, P) for the module.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from kubernetes_tpu.models import assign as jax_assign  # noqa: E402
from kubernetes_tpu.ops.flatten import Caps as JaxCaps  # noqa: E402
from kubernetes_tpu_torch.models import assign  # noqa: E402
from torch_cases import (  # noqa: E402
    FULL_CASES, K_CAP, make_full_case, run_port_full_step,
)


@pytest.fixture(scope="module")
def jax_full_fn():
    built = {}

    def get(caps, p_cap):
        key = (tuple(sorted(vars(caps).items())), p_cap)
        if key not in built:
            built[key] = jax_assign.build_packed_assign_fn(
                JaxCaps(**vars(caps)), p_cap, K_CAP,
                features=jax_assign.ALL_FEATURES)[0]
        return built[key]
    return get


def packed_full(caps, batch, patches):
    """The port's full wire buffer, checked byte for byte against the JAX
    package's packing of the same batch."""
    P = batch.p_cap
    rows, vals = patches if patches else (None, None)
    buf = assign.pack_pod_batch(batch, assign.PackSpec(caps, P, K_CAP),
                                rows, vals)
    ref = jax_assign.pack_pod_batch(
        batch, jax_assign.PackSpec(JaxCaps(**vars(caps)), P, K_CAP), rows,
        vals)
    np.testing.assert_array_equal(buf.view(np.int32), ref.view(np.int32))
    return buf


def run_jax(fn, state, static, buf):
    st, res = fn({k: jnp.asarray(v) for k, v in state.items()},
                 {k: jnp.asarray(v) for k, v in static.items()},
                 jnp.asarray(buf))
    return {k: np.asarray(v) for k, v in st.items()}, np.asarray(res)


@pytest.mark.parametrize("name", sorted(FULL_CASES))
def test_full_step_bit_identical(name, jax_full_fn):
    caps, state, static, batch, patches = make_full_case(name)
    P = batch.p_cap
    buf = packed_full(caps, batch, patches)
    jst, jres = run_jax(jax_full_fn(caps, P), state, static, buf)
    tst, tres = run_port_full_step(caps, P, state, static, buf)
    np.testing.assert_array_equal(tres, jres)
    for k in assign.STATE_KEYS:
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    placed = (tres[:-2] >= 0).sum()
    assert placed > 0
    if P > assign.TAIL_P:
        assert placed > assign.TAIL_P and jres[-2] > 1

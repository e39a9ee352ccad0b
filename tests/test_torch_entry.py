"""The port's entry points (kubernetes_tpu_torch/entry.py) held
against the repo root's __graft_entry__.py on the CPU.

entry(device="cpu")'s step on its example gives the JAX entry()'s
assignments (its fn jitted on the CPU, in this process; the JAX file
itself is not edited), dryrun_multichip(4, devices="cpu") passes its own
checks on four CPU shards, and without a GPU the entry points raise
unless the caller names the CPU.  The dry run runs under a deadline
(SIGALRM), as the seam tests do.
"""

import signal

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch import entry as port_entry
from kubernetes_tpu_torch.models import assign
from kubernetes_tpu_torch.ops.flatten import Caps

DEADLINE_S = 240


@pytest.fixture
def deadline():
    def expire(*_a):
        raise TimeoutError(f"dry run exceeded {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def test_entry_matches_the_jax_entry():
    jax = pytest.importorskip("jax")
    import __graft_entry__ as graft
    fn, args = graft.entry()
    want = np.asarray(jax.jit(fn)(*args)["assignments"])
    pfn, pargs = port_entry.entry(device="cpu")
    node, batch = pargs
    assert batch.p_cap == 64 and node["alloc"].shape[0] == 256
    got = pfn(*pargs)
    np.testing.assert_array_equal(got["assignments"], want)
    assert (want >= 0).all()


def test_dryrun_multichip_on_four_cpu_shards(deadline, capsys):
    out = port_entry.dryrun_multichip(4, devices="cpu")
    assert out["mesh"] == ["cpu"] * 4
    assert out["step_placed"] > 0 and out["scheduler_bound"] == 16
    placed, offered, _rate = out["sharded"]
    assert placed == offered and offered >= 512
    assert out["single"][0] == out["single"][1]
    printed = capsys.readouterr().out
    assert "parity ok" in printed and "bound 16/16" in printed


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is visible")
def test_entry_points_need_a_gpu_unless_told_cpu():
    caps = Caps(n_cap=16, l_cap=16, kl_cap=8, t_cap=4, pt_cap=4, s_cap=1,
                sg_cap=2, asg_cap=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    for mode in ("wave", "scan"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            assign.build_assign_fn(caps, mode=mode)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)

"""ROADMAP Q4: the claims kernel's cross-slice prune record under every
order of publishing (tests/claims_slice_model.py, a CPU model of
csrc/claims.cu's slice loop with one task a (pod block, slice)).

The model's claims and best must equal the plain version's
(kernels.claims_reference) bit for bit under every order of ORDERS, on
the launches a plain step makes (TorchBatchBackend on the CPU at sin and
murmur noise: the first wave on an empty cluster of identical nodes,
where ties among the top noise values decide, and the later waves), with
the slice width the kernel takes on an H100 (132 SMs) and with slices of
several node-row tiles (a smaller card's geometry), so that blocks also
share mid-slice.  A model of
the kernel with the prune rule broken (a record's index ignored) must
disagree, which shows the orders reach the record.

    python tests/test_torch_claims_slices.py   # phase 4's shapes
    python tests/test_torch_claims_slices.py --cpu-repeats 20

runs the same check at chip_smoke.py phase 4's shapes (5,000 nodes, two
batches of 4,096 pods, sin noise, 132 SMs), or repeats the plain version
on the CPU on phase 4's first sin launch (cpu_repeats).
"""

import sys

import numpy as np
import pytest
import torch

import claims_slice_model as model
from kubernetes_tpu_torch.ops import kernels


def slice_launches(n_nodes, batch, batches, noise, seed=7):
    """Every claims call of a plain TorchBatchBackend on the CPU driving
    `batches` batches of `batch` SchedulingBasic pods on `n_nodes`
    identical nodes (chip_smoke.py phase 4's slice): (inputs, outputs)."""
    from kubernetes_tpu_torch.ops import backend as port_backend
    from kubernetes_tpu_torch.perf import caps_for_nodes
    from kubernetes_tpu_torch.scheduler.cache import Cache
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    from kubernetes_tpu_torch.testing import make_node, make_pod
    cache = Cache()
    cache.add_nodes([make_node(f"node-{seed}-{i}").capacity(
        cpu="32", mem="256Gi", pods=110).build() for i in range(n_nodes)])
    kept = []
    real = kernels.claims

    def claims(static, active, used, used_nz, npods, noise="sin",
               pod_ids=None, node_offset=0):
        assert node_offset == 0, "a single-device slice"
        out = real(static, active, used, used_nz, npods, noise=noise,
                   pod_ids=pod_ids)
        kept.append(((dict(static), active.clone(), used.clone(),
                      used_nz.clone(), npods.clone(), noise,
                      None if pod_ids is None else pod_ids.clone()),
                     tuple(t.clone() for t in out)))
        return out
    kernels.claims = claims
    try:
        backend = port_backend.TorchBatchBackend(
            caps_for_nodes(n_nodes), batch_size=batch, device="cpu",
            claims_noise=noise)
        view = cache.flatten_view()
        backend.prefetch(view)
        for b in range(batches):
            infos = [PodInfo(make_pod(f"s-{b}-{i}").req(
                cpu="100m", mem="128Mi").build()) for i in range(batch)]
            out = backend.assign(infos, view)
            items = []
            for pi, (name, _st) in zip(infos, out):
                if name:
                    pod = {**pi.pod, "spec": {**pi.pod["spec"],
                                              "nodeName": name}}
                    items.append((pod, pi.clone_with_pod(pod)))
            assert not any(cache.assume_pods(items))
    finally:
        kernels.claims = real
    return kept


def check_launches(kept, sms, orders=model.ORDERS, broken=False,
                   width=None):
    """Every launch under every order against its plain output; returns
    the pods whose claim or best differs, summed."""
    off = 0
    for (static, active, used, used_nz, npods, noise, ids), (want, wbest) \
            in kept:
        mask, value, upper = model.planes(static, active, used, used_nz,
                                          npods, noise, ids)
        R = static["shape"][2]
        for order in orders:
            got, best, _stats = model.emulate(mask, value, upper, R, order,
                                              sms, broken, width)
            off += int(((got != want.numpy())
                        | (best != wbest.numpy())).sum())
    return off


@pytest.fixture(scope="module", params=["sin", "murmur"])
def launches(request):
    return slice_launches(1000, 1024, 2, request.param)


@pytest.mark.parametrize("width", [None, 10 * model.C["TN"]],
                         ids=["h100", "tiles"])
def test_every_order_of_publishing_gives_the_plain_answer(launches, width):
    P, N, _R = launches[0][0][0]["shape"]
    # the H100's width: one tile a slice, sharing at its start and end;
    # 10 tiles: a share point every TNS nodes inside the slice too
    w = width or model.slice_width(P, N)
    assert (w > model.C["TNS"]) == (width is not None)
    assert len(launches) >= 2
    assert check_launches(launches, model.H100_SMS, width=width) == 0


def test_the_orders_reach_the_record():
    """On the tied empty cluster (the sin slice's first wave) the prune
    skips the noise of the cells after a pod's first cell at the top
    value, and with the record's tie rule broken (a
    published cell beating equal values at lower indices of this slice)
    an order changes answers: the model's orders do exercise the
    record."""
    first = slice_launches(1000, 1024, 1, "sin")[:1]
    static, active, used, used_nz, npods, noise, ids = first[0][0]
    mask, value, upper = model.planes(static, active, used, used_nz, npods,
                                      noise, ids)
    _c, _b, stats = model.emulate(mask, value, upper, static["shape"][2],
                                  "ascending")
    assert stats["noise_cells"] < stats["live_cells"], stats
    assert check_launches(first, model.H100_SMS, orders=("descending",),
                          broken=True) > 0


def cpu_repeats(n):
    """The plain version on the CPU, on phase 4's first sin launch, `n`
    times in this process: whether the noise plane, torch.max's first
    index of the maximum and the claims come out as the first time."""
    kept = slice_launches(5000, 4096, 1, "sin")
    static, active, used, used_nz, npods, noise, ids = kept[0][0]
    want = kept[0][1][0]
    P, N, _R = static["shape"]
    pid = torch.arange(P, dtype=torch.int32)
    noise0 = kernels.sin_noise(pid, N)
    mask, value, _upper = model.planes(static, active, used, used_nz, npods,
                                       noise)
    masked = torch.where(torch.from_numpy(mask), torch.from_numpy(value),
                         torch.tensor(model.NEG))
    best = masked.max(dim=1).values
    # the first index of the maximum by an integer min: no tie to break
    first = torch.where(masked == best[:, None], torch.arange(N),
                        N).min(dim=1).values
    print(f"torch {torch.__version__}, {torch.get_num_threads()} threads; "
          f"first run: claims equal the first-index rule "
          f"{bool(torch.equal(want.long(), first))}", flush=True)
    bad = 0
    for r in range(n):
        nz = int((kernels.sin_noise(pid, N) != noise0).sum())
        idx = masked.max(dim=1).indices
        got = kernels.claims_reference(static, active, used, used_nz, npods,
                                       noise="sin")[0]
        off = (int((idx != first).sum()), int((got != want).sum()))
        bad += bool(nz or off[0] or off[1])
        print(f"repeat {r}: noise cells that differ {nz}; torch.max index "
              f"off the first-index rule {off[0]}; claims that differ from "
              f"the first run {off[1]}", flush=True)
    return 1 if bad else 0


def main(argv):
    """Phase 4's shapes: 5,000 nodes, two batches of 4,096, sin, 132
    SMs; with --cpu-repeats N, cpu_repeats(N) instead."""
    if argv[:1] == ["--cpu-repeats"]:
        return cpu_repeats(int(argv[1]))
    kept = slice_launches(5000, 4096, 2, "sin")
    print(f"{len(kept)} claims launches at "
          f"{kept[0][0][0]['shape'][:2]} (pods, node rows)", flush=True)
    for i, launch in enumerate(kept):
        off = check_launches([launch], model.H100_SMS)
        print(f"launch {i}: pods that differ from the plain version, over "
              f"{len(model.ORDERS)} orders: {off}", flush=True)
        if off:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

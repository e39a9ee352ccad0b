"""Device cost census of the sharded step.

Counterpart of kubernetes_tpu/parallel/census.py.  The JAX census lowers
the sharded program at abstract shapes and counts the collectives in its
HLO; torch cannot cost a program without running it, so
ShardedTorchBatchBackend.device_census runs one step of each variant on a
clone of the resident state (ops/backend.census_run), at the shapes
step_shapes gives, and reads the collectives off the step's comm
(models/assign._Comm): the bytes it counted by kind, per wave and per
call.  They are counts of what a mesh of distinct devices would move, not
a measurement of a transfer: shards that share a card copy nothing.
"""

from __future__ import annotations

from ..ops.flatten import Caps


def round_caps_to_mesh(caps: Caps, n_dev: int) -> Caps:
    """Round n_cap up to a mesh multiple (the shards split the node axis
    evenly); mutates and returns caps, mirroring the backend's own
    divisibility requirement."""
    if caps.n_cap % n_dev:
        caps.n_cap += n_dev - caps.n_cap % n_dev
    return caps


def step_shapes(caps: Caps, n_shards: int, batch: int,
                k_cap: int = 1024) -> dict:
    """The shapes one census step runs at, per shard: {"state": ...,
    "static": ..., "buf": ...} where a sharded array's entry is one
    shard's piece and a replicated one's the whole array (home).  The
    single definition of the shapes the census is pinned at (the
    counterpart of the JAX census's abstract_step_inputs): the pod side
    is the packed wire buffer of `batch` pods with k_cap patch rows, for
    each variant."""
    from ..models.assign import PackSpec
    c = caps
    n = c.n_cap // n_shards
    R, PT = c.r, c.pt_cap
    state = {"used": (n, R), "used_nz": (n, R), "npods": (n,),
             "port_mask": (n, PT), "cd_sg": (c.sg_cap, c.n_cap),
             "cd_asg": (c.asg_cap, c.n_cap), "gen": ()}
    static = {"alloc": (n, R), "maxpods": (n,), "valid": (n,),
              "taint_mask": (n, c.t_cap), "label_mask": (n, c.l_cap),
              "key_mask": (n, c.kl_cap), "dom_sg": (c.sg_cap, n),
              "dom_asg": (c.asg_cap, n),
              "sg_ns_mask": (c.sg_cap, c.ns_cap + 1),
              "asg_ns_mask": (c.asg_cap, c.ns_cap + 1)}
    buf = {v: (PackSpec(c, batch, k_cap, plain=v == "plain").total,)
           for v in ("full", "plain")}
    return {"state": state, "static": static, "buf": buf}


def collective_record(counts: dict, waves: int) -> dict:
    """A comm's counts (_Comm.counts: phase -> kind -> bytes, and
    "<kind> calls") of one step of `waves` waves, in the JAX census's
    record form: {"collectives": {kind: {op, count, bytes, per_wave}},
    "per_call_bytes", "per_wave_bytes"}.  A per-wave entry's count and
    bytes are the wave average (count: calls a wave; bytes: per call),
    so bytes * count sums to the bytes a wave, as in the JAX record."""
    out = {}
    per_wave = per_call = 0.0
    for phase, tally in counts.items():
        wave = phase == "wave"
        for kind, nbytes in tally.items():
            calls = tally.get(kind + " calls", 0)
            if kind.endswith(" calls") or not calls:
                continue
            count = calls / waves if wave and waves else calls
            out[f"{kind} ({phase})"] = {
                "op": kind, "count": count, "bytes": nbytes / calls,
                "per_wave": wave}
            if wave:
                per_wave += nbytes / waves if waves else 0.0
            else:
                per_call += nbytes
    return {"collectives": out, "per_call_bytes": per_call,
            "per_wave_bytes": per_wave}

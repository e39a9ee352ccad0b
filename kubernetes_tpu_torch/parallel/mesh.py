"""Device-mesh sharding of the scheduler's device path.

Counterpart of kubernetes_tpu/parallel/mesh.py.  The node axis is this
workload's long axis (100k+ nodes); it shards across devices in contiguous
slabs of n_cap / S rows.  Each shard computes its nodes' feasibility and
scores, placement is a per-shard top-1 combined into the global first
best, and the running-sum state (used/npods/ports) lives sharded.  The
small domain-count tables (cd_sg/cd_asg), the generation counter and the
pod side live on the first shard's device.

One controller drives every shard, as JAX's shard_map does: a mesh is a
list of torch devices, a sharded array a list of per-shard tensors, and
the collectives are torch operations on those lists
(models/assign.py _Comm).  Several shards may share one device (a mesh of
four shards on one card, or of eight on the CPU, where JAX's tests run on
eight virtual CPU devices), and then the collectives copy nothing.  A
process group would need one process per shard behind a BatchBackend that
lives in the Scheduler's process (a second remote seam), and NCCL refuses
two ranks on one GPU, so on one card it could only run one shard.

Shardings are declarative: NODE_PARTITION_RULES maps every node-side array
name to the axis it splits (match_partition_rules raises on a name no rule
matches), and split_arrays / gather_arrays apply the table to a dict of
arrays.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..models.assign import (
    ALL_FEATURES, MAX_WAVES, NS_MASKS, REP_STATE, _Comm, make_step,
)
from ..ops.flatten import Caps

NODE_AXIS = "nodes"

# Sentinel used in NODE_PARTITION_RULES entries; substituted with the
# mesh axis name by match_partition_rules.
_AXIS = "@nodes"

# Rule table: (name regex, spec dims) — every node-side array entering the
# sharded step MUST match exactly one rule, so a new array cannot silently
# default to replicated (match_partition_rules raises on a miss).
NODE_PARTITION_RULES = (
    # [n_cap, *] row-major node tensors: shard the node axis
    (r"^(alloc|used|used_nz|taint_mask|label_mask|key_mask|port_mask)$",
     (_AXIS, None)),
    # [n_cap] per-node vectors
    (r"^(npods|maxpods|valid)$", (_AXIS,)),
    # [cap, n_cap] domain-id tables: node axis is the LAST dim
    (r"^dom_(sg|asg)$", (None, _AXIS)),
    # [cap, dom] per-domain count tables stay replicated: every shard
    # gathers its nodes' domain ids into them and the commits add into one
    # table; a sharded copy would add a collective per constraint slot
    (r"^cd_(sg|asg)$", ()),  # replicated-ok: kernel-coherent count table
    # [cap, ns_vocab] namespace masks have no node axis and fold into
    # pod bits once per batch (_fold_ns_masks)
    (r"^(sg|asg)_ns_mask$", ()),  # replicated-ok: no node axis
    # scalar state-generation counter (the resolve fence)
    (r"^gen$", ()),  # replicated-ok: scalar counter
)


def match_partition_rules(rules, names, axis: str = NODE_AXIS) -> dict:
    """Resolve array names against a (regex, spec-dims) rule table into
    {name: spec}, a spec being a tuple of one entry per dimension (the
    axis name where that dimension is split, None where it is not; ()
    for replicated).  First match wins; an unmatched name raises so
    sharding stays exhaustive by construction."""
    specs = {}
    for name in names:
        for pattern, dims in rules:
            if re.search(pattern, name):
                specs[name] = tuple(axis if d == _AXIS else d for d in dims)
                break
        else:
            raise ValueError(
                f"no partition rule matches node array {name!r} — add it "
                f"to NODE_PARTITION_RULES")
    return specs


class Mesh:
    """The shards' devices along one named axis: shard s holds node rows
    [s * n_cap / S, (s + 1) * n_cap / S) on devices[s]; devices[0] is the
    home of the pod side and the replicated arrays."""

    def __init__(self, devices, axis: str = NODE_AXIS):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices=None, shards: int | None = None,
              axis: str = NODE_AXIS) -> Mesh:
    """A mesh over `devices`: by default every visible CUDA device (one
    shard each; raises without a GPU), or one device ("cpu", "cuda:0"), or
    a list.  `shards` cycles the devices to that many shards, so
    make_mesh("cuda:0", shards=4) is four shards on one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices "
                "(e.g. make_mesh('cpu', shards=8)) to shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [torch.device(d) for d in devices]
    # a bare "cuda" names the current card, so shards compare equal
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if shards is not None:
        devices = [devices[i % len(devices)] for i in range(shards)]
    return Mesh(devices, axis)


NODE_KEYS = ("alloc", "used", "used_nz", "npods", "maxpods", "valid",
             "taint_mask", "label_mask", "key_mask", "port_mask",
             "dom_sg", "dom_asg", "cd_sg", "cd_asg",
             "sg_ns_mask", "asg_ns_mask")


def node_specs(axis: str = NODE_AXIS) -> dict:
    """Spec per node-side array, resolved from the rule table."""
    return match_partition_rules(NODE_PARTITION_RULES, NODE_KEYS, axis)


def pod_specs() -> dict:
    """Pod-side arrays are replicated (the batch is small): they travel in
    the packed wire buffer to the home device (models/assign.PackSpec)."""
    keys = ["req", "req_nz", "p_valid", "untol_hard", "untol_prefer",
            "sel_any", "sel_any_active", "sel_forb", "key_any",
            "key_any_active", "key_forb", "ports", "node_row", "c_kind",
            "c_sg", "c_maxskew", "c_selfmatch", "c_weight", "inc_sg",
            "inc_asg", "match_asg", "pod_ns"]
    return {k: () for k in keys}


AGGREGATE_KEYS = ("used", "used_nz", "npods", "port_mask", "cd_sg", "cd_asg")
STATE_KEYS = AGGREGATE_KEYS + ("gen",)
STATIC_KEYS = ("alloc", "maxpods", "valid", "taint_mask", "label_mask",
               "key_mask", "dom_sg", "dom_asg", "sg_ns_mask", "asg_ns_mask")


def state_specs(axis: str = NODE_AXIS) -> dict:
    return match_partition_rules(NODE_PARTITION_RULES, STATE_KEYS, axis)


def static_specs(axis: str = NODE_AXIS) -> dict:
    ns = node_specs(axis)
    return {k: ns[k] for k in STATIC_KEYS}


def _split_dim(spec: tuple, axis: str) -> int | None:
    return spec.index(axis) if axis in spec else None


def split_arrays(arrays: dict, mesh: Mesh, axis: str = NODE_AXIS) -> dict:
    """Place a dict of whole arrays (numpy or tensors) on the mesh by the
    rule table: a sharded array becomes a list of its S contiguous pieces,
    each on its shard's device; a replicated one a tensor on the home
    device.  Every piece is a copy the caller may update in place."""
    specs = match_partition_rules(NODE_PARTITION_RULES, arrays, axis)
    out = {}
    for name, a in arrays.items():
        t = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        dim = _split_dim(specs[name], axis)
        if dim is None:
            # sync-point: a pageable host-to-device copy (between waves)
            out[name] = t.to(mesh.home, copy=True)
            continue
        if t.shape[dim] % mesh.size:
            raise ValueError(f"{name}: {t.shape[dim]} rows do not divide by "
                             f"{mesh.size} shards (round_caps_to_mesh)")
        # sync-point: pageable host-to-device copies (between waves)
        out[name] = [p.to(d, copy=True).contiguous() for p, d
                     in zip(t.chunk(mesh.size, dim), mesh.devices)]
    return out


def gather_arrays(arrays: dict, axis: str = NODE_AXIS) -> dict:
    """Inverse of split_arrays: whole arrays as numpy, the pieces of a
    sharded array concatenated along its node axis."""
    specs = match_partition_rules(NODE_PARTITION_RULES, arrays, axis)
    out = {}
    for name, a in arrays.items():
        dim = _split_dim(specs[name], axis)
        if dim is None:
            # sync-point: the whole array pulled to the host, on purpose
            out[name] = a.cpu().numpy()
        else:
            # sync-point: the shards pulled to the host, on purpose
            out[name] = torch.cat([p.cpu() for p in a], dim).numpy()
    return out


class ShardedStep:
    """The resident-state sharded step (the counterpart of
    build_sharded_step_fn's program): models/assign.make_step over the
    mesh's shards.  `run(state, static, buf)` updates `state` in place and
    returns the int32[p_cap+2] result vector on the home device (global
    rows per pod slot, the wave count, the generation); calling the step
    returns (state, assignments, waves, gen), views of that vector.

    `state` holds the STATE_KEYS (used, used_nz, npods, port_mask as
    per-shard lists; cd_sg, cd_asg, gen on home), `static` the
    STATIC_KEYS the variant reads (the sharded ones as lists; the plain
    variant reads alloc, maxpods, valid and taint_mask only), `buf` the
    packed wire buffer (models/assign.pack_pod_batch) on home, whose row
    patches name GLOBAL rows: each shard applies the ones in its slab (an
    index_add_ of the new value less the current one); the out-of-shard
    and padding rows add zero, so no row takes another's values."""

    def __init__(self, caps: Caps, mesh: Mesh, p_cap: int,
                 k_cap: int = 1024, weights: dict[str, float] | None = None,
                 features: frozenset = ALL_FEATURES,
                 max_waves: int = MAX_WAVES, comm: _Comm | None = None):
        if caps.n_cap % mesh.size:
            raise ValueError(f"n_cap {caps.n_cap} not divisible by "
                             f"{mesh.size} shards")
        self.mesh, self.p_cap = mesh, p_cap
        self.comm = comm if comm is not None else _Comm(mesh.devices)
        self.step, self.spec = make_step(
            caps, self.comm, p_cap, k_cap, weights, features, max_waves,
            claims_noise="murmur")

    def run(self, state: dict, static: dict, buf):
        nodes = []
        for s in range(self.mesh.size):
            nd = {k: v[s] for k, v in static.items()
                  if isinstance(v, (list, tuple))}
            nd.update({k: state[k][s] for k in
                       ("used", "used_nz", "npods", "port_mask")})
            nodes.append(nd)
        rep = {k: state[k] for k in REP_STATE}
        rep.update({k: static[k] for k in NS_MASKS if k in static})
        return self.step(nodes, rep, buf)

    def __call__(self, state: dict, static: dict, buf):
        result = self.run(state, static, buf)
        p = self.p_cap
        return state, result[:p], result[p], result[p + 1]


def build_sharded_step_fn(caps: Caps, mesh: Mesh, p_cap: int,
                          weights: dict[str, float] | None = None,
                          k_cap: int = 1024, features=None,
                          max_waves: int = MAX_WAVES) -> ShardedStep:
    """The resident-state sharded step fn(state, static, buf) ->
    (new_state, assignments, waves, gen), state updated in place (JAX
    donates it); see ShardedStep.  `features` defaults to ALL_FEATURES,
    max_waves to the JAX core's 128 for both variants."""
    return ShardedStep(caps, mesh, p_cap, k_cap, weights,
                       ALL_FEATURES if features is None else features,
                       max_waves)


def build_sharded_assign_fn(caps: Caps, mesh: Mesh, p_cap: int,
                            weights: dict[str, float] | None = None,
                            features=None, max_waves: int = MAX_WAVES):
    """The snapshot form: fn(node, batch) -> {"assignments", "waves",
    "used", "used_nz", "npods", "port_mask", "cd_sg", "cd_asg"} as numpy,
    for whole node arrays `node` (NODE_KEYS, numpy or tensors) and a
    PodBatch of p_cap slots (ops/flatten.BatchEncoder): the arrays are
    split over the mesh, one step runs, and the state is gathered back.
    caps.n_cap must divide by the mesh size."""
    from ..models.assign import pack_pod_batch
    step = build_sharded_step_fn(caps, mesh, p_cap, weights,
                                 features=features, max_waves=max_waves)

    def fn(node: dict, batch) -> dict:
        arrays = dict(node)
        arrays["gen"] = np.int32(0)
        placed = split_arrays(arrays, mesh)
        state = {k: placed[k] for k in STATE_KEYS}
        static = {k: placed[k] for k in STATIC_KEYS if k in placed}
        buf = torch.from_numpy(pack_pod_batch(batch, step.spec)).to(
            mesh.home)
        state, assignments, waves, _gen = step(state, static, buf)
        out = gather_arrays({k: state[k] for k in AGGREGATE_KEYS})
        # sync-point: the step's results pulled to the host
        out["assignments"] = assignments.cpu().numpy()
        # sync-point: the wave count, with the results
        out["waves"] = int(waves)
        return out

    return fn

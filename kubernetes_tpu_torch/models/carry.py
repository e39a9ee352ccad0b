"""Resident state across the two packages.

The scheduler has no weights: what a step carries is its resident device
state (the aggregates in STATE_KEYS) and the static node arrays: the JAX
backend's STATIC_CORE, which every step reads, and STATIC_SEL, the
selector-side arrays only the full variant reads.  These two functions move
them between the JAX package's numpy form and the port's tensors, so a test
can start both steps from one state and compare the states they leave.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .assign import STATE_KEYS

STATIC_CORE = ("alloc", "maxpods", "valid", "taint_mask")
# sg_ns_mask/asg_ns_mask have no node axis (per-slot namespace masks):
# they ride full uploads only, never the row patch
STATIC_SEL = ("label_mask", "key_mask", "dom_sg", "dom_asg",
              "sg_ns_mask", "asg_ns_mask")


def state_from_reference(state_np: dict, static_np: dict, device=None):
    """(state, static) numpy dicts -> the port's tensors on `device`.
    `gen` becomes a 0-d int32 tensor; every array keeps its dtype and is
    copied, so the port's in-place updates never write into the caller's
    arrays.  The static dict carries STATIC_CORE and whichever STATIC_SEL
    arrays static_np holds."""
    dev = resolve_device(device)
    state = {k: torch.tensor(np.asarray(state_np[k]), device=dev)
             for k in STATE_KEYS if k != "gen"}
    state["gen"] = torch.tensor(int(np.asarray(state_np["gen"])),
                                dtype=torch.int32, device=dev)
    static = {k: torch.tensor(np.asarray(static_np[k]), device=dev)
              for k in STATIC_CORE + STATIC_SEL if k in static_np}
    return state, static


def state_to_numpy(state: dict, static: dict | None = None):
    """Inverse of state_from_reference: the port's tensors -> numpy dicts
    (`gen` as np.int32).  Returns (state_np, static_np), static_np None
    when no static dict is given."""
    # sync-point: the whole state pulled to the host, on purpose
    state_np = {k: state[k].cpu().numpy() for k in STATE_KEYS if k != "gen"}
    # sync-point: the generation counter, with the state
    state_np["gen"] = np.int32(int(state["gen"]))
    if static is None:
        return state_np, None
    # sync-point: the static arrays pulled to the host, on purpose
    return state_np, {k: static[k].cpu().numpy()
                      for k in STATIC_CORE + STATIC_SEL if k in static}

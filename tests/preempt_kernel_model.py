"""A CPU model of the dry-run kernel's order of work (csrc/preempt.cu).

One loop per (pod, node) on numpy float32 scalars that does what a CUDA
thread does, block by block: the block's pods and their key flags, the
live-slot compaction against the block's highest pod priority, the
reprieve order over the live slots only, reuse of the eligible set, freed
resources, free0 and slack0 while (priority, group) repeats and of the
walk and victim planes while the request repeats too, and sums over
eligible slots or victims only, lowest slot first from +0.  Held bit for
bit against models/preempt.preempt_dry_run_reference, it tests on the CPU
that skipping slots is exact before the kernel reaches the card.
"""

import numpy as np

I32_MAX = 2**31 - 1
EPS = np.float32(1e-6)
F0 = np.float32(0.0)
F1 = np.float32(1.0)
PP = 64    # pods per block, as the kernel


class SlotCapExceeded(Exception):
    """A node holds more live slots than k_cap (the kernel traps)."""


def _before(a, b, prio, pdb):
    """The kernel's reprieve comparator on compacted slots a, b."""
    da, db = -pdb[a], -pdb[b]
    if da < db:
        return True
    if db < da:
        return False
    qa, qb = -int(prio[a]), -int(prio[b])
    if qa != qb:
        return qa < qb
    return a < b


def _bits(mask):
    """Set bit indices of `mask`, lowest first (the kernel's __ffs walk)."""
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


def dry_run_model(alloc, used, npods, maxpods, valid, taint_mask, vict_prio,
                  vict_req, vict_pdb, vict_over, nom_used, nom_np, group_idx,
                  req, prio, untol_hard, active, k_cap=None, pp=PP):
    """numpy in (models/preempt.py's argument order) -> (cand, viol,
    highest, psum, nvic, victims bool[P,N,V], overflow_hit), computed in
    the kernel's order.  k_cap defaults to the count of non-PAD slots."""
    P, R = req.shape
    N, V = vict_prio.shape
    if k_cap is None:
        k_cap = int((vict_prio != I32_MAX).sum(1).max()) if N else 0
    cand = np.zeros((P, N), bool)
    viol = np.zeros((P, N), np.float32)
    highest = np.zeros((P, N), np.int32)
    psum = np.zeros((P, N), np.float32)
    nvic = np.zeros((P, N), np.float32)
    victims = np.zeros((P, N, V), bool)
    overflow = np.zeros(P, bool)
    taint_n = taint_mask != 0
    untol_p = untol_hard != 0

    for b0 in range(0, P, pp):
        pods = range(b0, min(P, b0 + pp))
        pmax = max(int(prio[p]) for p in pods)
        # block-uniform key flags
        same_key = {p: p > b0 and prio[p] == prio[p - 1]
                    and group_idx[p] == group_idx[p - 1] for p in pods}
        same_req = {p: same_key[p] and req[p].view(np.uint32).tolist()
                    == req[p - 1].view(np.uint32).tolist() for p in pods}
        for n in range(N):
            # compaction, ascending slot order
            live = [v for v in range(V) if int(vict_prio[n, v]) < pmax]
            if len(live) > k_cap:
                raise SlotCapExceeded(f"node {n}: {len(live)} > {k_cap}")
            k = len(live)
            sp = [vict_prio[n, v] for v in live]
            sd = [vict_pdb[n, v] for v in live]
            sr = [vict_req[n, v] for v in live]
            order = []
            for i in range(k):              # insertion sort, as the kernel
                j = len(order)
                while j > 0 and _before(i, order[j - 1], sp, sd):
                    j -= 1
                order.insert(j, i)
            elig = 0
            fr0 = slack0 = freed_np = None
            fit_b, word = False, 0
            nv = vi = ps = F0
            hi = 0
            for p in pods:
                taint_ok = not (untol_p[p] & taint_n[n]).any()
                act = bool(active[p])
                if vict_over[n] and valid[n] and taint_ok and act:
                    overflow[p] = True
                if not same_key[p]:
                    elig = 0
                    for i in range(k):
                        if sp[i] < prio[p]:
                            elig |= 1 << i
                    freed = [F0] * R
                    freed_np = F0
                    for i in _bits(elig):
                        freed = [freed[r] + sr[i][r] for r in range(R)]
                        freed_np = freed_np + F1
                    g = group_idx[p]
                    fr0 = [(alloc[n, r] - (used[n, r] + nom_used[g, n, r]))
                           + freed[r] for r in range(R)]
                    slack0 = maxpods[n] - ((npods[n] + nom_np[g, n])
                                           - freed_np)
                if not same_req[p]:
                    rq = req[p]
                    fit_b = (all(rq[r] <= fr0[r] + EPS for r in range(R))
                             and slack0 >= F1 and bool(valid[n])
                             and freed_np > F0)
                    fr, slack, repr_ = list(fr0), slack0, 0
                    for i in order:
                        if not elig:
                            break
                        if not (slack - F1) >= F1:
                            break
                        if not (elig >> i) & 1:
                            continue
                        if all(rq[r] <= (fr[r] - sr[i][r]) + EPS
                               for r in range(R)):
                            fr = [fr[r] - sr[i][r] for r in range(R)]
                            slack = slack - F1
                            repr_ |= 1 << i
                    nv = vi = ps = F0
                    hi, word = -I32_MAX, 0
                    for i in _bits(elig & ~repr_):
                        nv = nv + F1
                        vi = vi + sd[i]
                        ps = ps + np.float32(sp[i])
                        hi = max(hi, int(sp[i]))
                        word |= 1 << live[i]
                    if not nv > F0:
                        hi = 0
                cand[p, n] = (fit_b and taint_ok and act and nv > F0
                              and not vict_over[n])
                viol[p, n], highest[p, n] = vi, hi
                psum[p, n], nvic[p, n] = ps, nv
                victims[p, n] = [(word >> v) & 1 for v in range(V)]
    return cand, viol, highest, psum, nvic, victims, overflow

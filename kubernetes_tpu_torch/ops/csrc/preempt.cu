// preempt: K7, the batched DryRunPreemption, one thread per (pod, node).
//
// Replaces the jit-compiled device program kubernetes_tpu/models/preempt.py
// (_preempt_dry_run :124-209).  Per (pod, node): evict every victim of lower
// priority than the pod, fit-check the pod on what is left (resources, pod
// count, taints, the capacity nominated pods claim), then re-add the victims
// one by one in the node's reprieve order (PDB-covered first, then highest
// priority, then slot) keeping each one the pod still fits with.  Same
// outputs as the JAX program: cand (uint8 0/1), viol, highest, psum, nvic
// per (pod, node) and overflow_hit (uint8 0/1) per pod, except that the
// victims come as one 32-bit word per (pod, node), bit v = slot v
// (ops/flatten.py fills at most v_cap <= 32 slots a node); models/preempt.py
// expands the words.
//
// What bounds it.  Per cell it writes 21 bytes (five planes and the word);
// at the main path's chunk (P = 256 pods x N = 110,080 node rows, V = 16,
// R = 6) that is ~592 MB, 0.1767 ms at the H100's 3.35 TB/s (0.1984 ms
// with the inputs).  The work a cell needs is data-dependent: the eligible
// slots' freed resources and the reprieve walk over them.  An earlier
// design staged all V slots of a block's nodes in shared memory (67.6 KB a
// block, 12 warps an SM), packed the taint planes with torch on every call
// and walked all V slots for every pod: ~740 dependent instructions a
// cell, latency-bound at 30x the bytes bound.
//
// Design.  A block takes TN node rows, one per thread, and a range of pods,
// which each thread walks in turn, 64 pods staged at a time.
//   * The grid: when every node block is resident at once (resident blocks
//     an SM x SMs), a block takes all P pods, so each node's slots are
//     compacted once a call; otherwise the pods split into 64-pod ranges
//     (grid.y), so that the many rounds of blocks balance.
//   * Node side, once per block: each thread compacts its node's LIVE
//     slots (priority below the highest priority of the block's pods: a
//     PAD slot, I32_MAX, never is) into its column of shared memory, in
//     ascending slot order, node-minor ([slot][TN]: no bank conflict
//     whatever slot a thread reads), with their original slot index; then
//     sorts the reprieve order over its k live slots only.  Shared memory
//     is sized by k_cap, the largest live count the caller vouches for (a
//     node with more traps: a device-side error, never a wrong answer).
//     At k_cap = 4 a block of 128 takes ~20 KB, so registers (72 a thread
//     under the launch bounds at R = 6), not shared memory, set the
//     occupancy: 7 blocks, 28 warps an SM.
//   * Pod side, per 64-pod chunk: priority, group, request, active bit and
//     untolerated taints (packed to bits here from the 0/1 f32 plane) go
//     to shared memory, with two flags per pod: "same (priority, group) as
//     the pod before it" and "same request too" (bitwise).  The node's
//     taints are packed the first time a chunk holds a pod with an
//     untolerated taint, and never when none does.
//   * Per pod, work is recomputed only when its key changes (the flags are
//     block-uniform, so the branches do not diverge): on a new (priority,
//     group) the eligible set, the freed resources, free0 and slack0; on a
//     new request also the fit test, the reprieve walk and the victim
//     planes.  What is left per pod is the taint test, active, cand, the
//     overflow vote and the six stores: a wave of one template's replicas
//     is store-bound.
//   * Every loop runs over live slots, eligible slots or victims only, in
//     ascending slot order (a bit mask walked lowest bit first); the walk
//     stops once the slack forbids any reprieve (it never grows back).
//   * The planes are written at p * N + n: consecutive threads,
//     consecutive addresses; overflow_hit is a warp vote, lane 0 of a
//     warp that saw a hit stores 1 (the launch zeroes the plane first).
//
// Numerics, held bit for bit against the JAX program as XLA compiles it on
// the CPU (models/preempt.py): every sum over slots runs in ascending slot
// order from +0 (that is XLA's order there); the build passes -fmad=false,
// so nothing is contracted; the int32 -> f32 conversion of a priority
// rounds to nearest.  Skipping a slot is exact: the reference adds
// 0 * x = +-0 for it, and a sum that starts at +0 never becomes -0 under
// round-to-nearest, so adding +-0 never changes it.  The one exception is
// a non-finite request (or PDB value) in a slot that is not eligible (not
// a victim): the reference's 0 * inf is NaN, here the slot is skipped.
// ops/flatten.py never writes one.  The taint test compares bit masks: the
// JAX program's einsum of two 0/1 planes is 0 exactly when no bit is
// common.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int PP = 64;            // pods per block
constexpr int V_MAX = 32;         // victim slots (one bit each in the word)
constexpr int R_MAX = 16;         // resource columns
constexpr int TW_MAX = 32;        // taint words (T <= 1024)
constexpr int TN_MAX = 128;       // node rows per block (threads)
constexpr int WARPS_MAX = TN_MAX / 32;
constexpr size_t SMEM_TARGET = 112 * 1024;  // keep >= 2 blocks an SM
constexpr size_t SMEM_MAX = 232448;         // a block's ceiling on sm_90
constexpr float EPS = 1e-6f;
constexpr int32_t I32_MAX = 2147483647;

// per-pod flags (shared, block-uniform)
constexpr unsigned SAME_KEY = 1u;    // (priority, group) as the pod before
constexpr unsigned SAME_REQ = 2u;    // ... and the request, bitwise
constexpr unsigned ACTIVE = 4u;
constexpr unsigned UNTOL = 8u;       // has an untolerated taint

struct Args {
  const float* alloc;        // [N, R]
  const float* used;         // [N, R]
  const float* npods;        // [N]
  const float* maxpods;      // [N]
  const uint8_t* valid;      // [N]
  const float* taint;        // [N, T] 0/1
  const int32_t* vict_prio;  // [N, V]
  const float* vict_req;     // [N, V, R]
  const float* vict_pdb;     // [N, V]
  const uint8_t* vict_over;  // [N]
  const float* nom_used;     // [G, N, R]
  const float* nom_np;       // [G, N]
  const int32_t* group_idx;  // [P]
  const float* req;          // [P, R]
  const int32_t* prio;       // [P]
  const float* untol;        // [P, T] 0/1
  const uint8_t* active;     // [P]
  int P, N, V, R, T, TW, K;
  int ppb;                   // pods per block (blockIdx.y)
  uint8_t* cand;             // [P, N] outputs
  float* viol;
  int32_t* highest;
  float* psum;
  float* nvic;
  uint32_t* victims;
  uint8_t* overflow;         // [P]
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The shared layout of a block of tn node rows: 4-byte arrays first, the
// byte arrays after them.
struct Layout {
  size_t prio, pdb, req, taint, pprio, pgrp, preq, puntol, wmax, ord, slot,
      pflag, total;
  __host__ __device__ Layout(int tn, int K, int R, int TW) {
    const size_t cells = static_cast<size_t>(tn) * K;
    prio = 0;                                    // i32 [K][tn]
    pdb = prio + 4 * cells;                      // f32 [K][tn]
    req = pdb + 4 * cells;                       // f32 [K*R][tn]
    taint = req + 4 * cells * R;                 // u32 [TW][tn]
    pprio = taint + 4 * static_cast<size_t>(tn) * TW;   // i32 [PP]
    pgrp = pprio + 4 * PP;                       // i32 [PP]
    preq = pgrp + 4 * PP;                        // f32 [PP][R]
    puntol = preq + 4 * static_cast<size_t>(PP) * R;    // u32 [PP][TW]
    wmax = puntol + 4 * static_cast<size_t>(PP) * TW;   // i32 [WARPS_MAX]
    ord = wmax + 4 * WARPS_MAX;                  // u8 [K][tn]
    slot = ord + cells;                          // u8 [K][tn]
    pflag = slot + cells;                        // u8 [PP]
    total = (pflag + PP + 15) & ~static_cast<size_t>(15);
  }
};

// the widest block (128, 64 or 32 node rows) whose layout fits SMEM_TARGET,
// else 32 rows if they fit the ceiling, else 0
inline int block_nodes(int K, int R, int TW) {
  for (int tn = TN_MAX; tn >= 32; tn /= 2) {
    if (Layout(tn, K, R, TW).total <= SMEM_TARGET) return tn;
  }
  return Layout(32, K, R, TW).total <= SMEM_MAX ? 32 : 0;
}

// reprieve order: (-pdb, -priority, slot) ascending, jnp.lexsort((slot,
// -prio, -pdb))'s order.  Compacted slots keep ascending slot order, so
// the compacted index breaks ties as the slot does.  -prio is taken in 64
// bits (no overflow).
__device__ __forceinline__ bool reprieve_before(int a, int b,
                                                const int32_t* s_prio,
                                                const float* s_pdb, int TN,
                                                int t) {
  const float da = -s_pdb[a * TN + t];
  const float db = -s_pdb[b * TN + t];
  if (da < db) return true;
  if (db < da) return false;
  const long long qa = -static_cast<long long>(s_prio[a * TN + t]);
  const long long qb = -static_cast<long long>(s_prio[b * TN + t]);
  if (qa < qb) return true;
  if (qb < qa) return false;
  return a < b;
}

// 32 taint flags of row `row` from word w of a [rows, T] 0/1 plane
__device__ __forceinline__ uint32_t pack_word(const float* plane, size_t row,
                                              int T, int w) {
  uint32_t bits = 0;
  const int b1 = min(32, T - 32 * w);
  for (int b = 0; b < b1; ++b) {
    if (plane[row * T + 32 * w + b] != 0.f) bits |= 1u << b;
  }
  return bits;
}

// Blocks of 128 an SM the registers must allow: as many as leave each
// instantiation without spills on sm_90a (ptxas -v): 7 at R = 6 (72
// registers, 28 warps an SM; under 64 registers it spills), 6 at R <= 8,
// 4 at R <= 16.
template <int RB>
struct MinBlocks {
  static constexpr int value = RB == 6 ? 7 : RB <= 8 ? 6 : 4;
};

// RB bounds R (the R-vectors stay in registers); EXACT: R == RB
template <int RB, bool EXACT>
__global__ void __launch_bounds__(TN_MAX, MinBlocks<RB>::value)
    dry_run_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TN = blockDim.x;
  const int R = EXACT ? RB : a.R;
  const int N = a.N, V = a.V, T = a.T, TW = a.TW, K = a.K;
  const Layout L(TN, K, R, TW);
  int32_t* s_prio = reinterpret_cast<int32_t*>(smem + L.prio);
  float* s_pdb = reinterpret_cast<float*>(smem + L.pdb);
  float* s_req = reinterpret_cast<float*>(smem + L.req);
  uint32_t* s_taint = reinterpret_cast<uint32_t*>(smem + L.taint);
  int32_t* s_pprio = reinterpret_cast<int32_t*>(smem + L.pprio);
  int32_t* s_pgrp = reinterpret_cast<int32_t*>(smem + L.pgrp);
  float* s_preq = reinterpret_cast<float*>(smem + L.preq);
  uint32_t* s_puntol = reinterpret_cast<uint32_t*>(smem + L.puntol);
  int32_t* s_wmax = reinterpret_cast<int32_t*>(smem + L.wmax);
  uint8_t* s_ord = smem + L.ord;
  uint8_t* s_slot = smem + L.slot;
  uint8_t* s_pflag = smem + L.pflag;

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * TN;
  const int nn = min(TN, N - n0);
  const int n = n0 + t;
  const bool live = t < nn;
  const int pb = blockIdx.y * a.ppb;             // this block's pods
  const int pe = min(a.P, pb + a.ppb);

  // the highest priority among them bounds which slots can be eligible
  int32_t pmax = -I32_MAX - 1;
  for (int p = pb + t; p < pe; p += TN) pmax = max(pmax, a.prio[p]);
  pmax = __reduce_max_sync(0xffffffffu, pmax);
  if ((t & 31) == 0) s_wmax[t >> 5] = pmax;
  const bool valid_n = live && a.valid[n] != 0;
  const bool over_n = live && a.vict_over[n] != 0;
  __syncthreads();
  pmax = s_wmax[0];
  for (int w = 1; w < TN / 32; ++w) pmax = max(pmax, s_wmax[w]);

  // compact the live slots (ascending slot order), then sort the reprieve
  // order over them
  int k = 0;
  if (live) {
    const size_t row = static_cast<size_t>(n) * V;
    for (int v = 0; v < V; ++v) {
      const int32_t pv = a.vict_prio[row + v];
      if (pv >= pmax) continue;
      if (k >= K) __trap();   // the caller's k_cap is wrong
      s_prio[k * TN + t] = pv;
      s_pdb[k * TN + t] = a.vict_pdb[row + v];
      s_slot[k * TN + t] = static_cast<uint8_t>(v);
      const float* src = a.vict_req + (row + v) * R;
      for (int r = 0; r < R; ++r) s_req[(k * R + r) * TN + t] = src[r];
      ++k;
    }
    for (int i = 0; i < k; ++i) {
      int j = i - 1;
      while (j >= 0 &&
             reprieve_before(i, s_ord[j * TN + t], s_prio, s_pdb, TN, t)) {
        s_ord[(j + 1) * TN + t] = s_ord[j * TN + t];
        --j;
      }
      s_ord[(j + 1) * TN + t] = static_cast<uint8_t>(i);
    }
  }

  // what a pod's key decides, kept across pods of the same key
  uint32_t elig = 0;             // eligible live slots (compacted bits)
  float fr0[RB];                 // free0 = (alloc - eff_used) + freed
  float slack0 = 0.f, freed_np = 0.f;
  bool fit_b = false;            // fits0 without taint and active
  float nv = 0.f, vi = 0.f, ps = 0.f;
  int32_t hi = 0;
  uint32_t word = 0;             // victims, bit v = slot v
#pragma unroll
  for (int r = 0; r < RB; ++r) fr0[r] = 0.f;
  // the node's taint bits, packed when a pod first has an untolerated one
  bool packed = false, tainted = false;

  for (int p0 = pb; p0 < pe; p0 += PP) {
    const int np = min(PP, pe - p0);
    if (p0 > pb) __syncthreads();   // the last chunk's pods are read
    // this chunk's pods and their key flags (against the pod before,
    // across chunk edges too)
    bool untol_any = false;
    for (int q = t; q < np; q += TN) {
      const int p = p0 + q;
      const int32_t pr = a.prio[p];
      const int32_t g = a.group_idx[p];
      s_pprio[q] = pr;
      s_pgrp[q] = g;
      const bool first = p == pb;
      bool same_req = !first;
      for (int r = 0; r < R; ++r) {
        const float x = a.req[static_cast<size_t>(p) * R + r];
        s_preq[q * R + r] = x;
        if (!first) {
          same_req = same_req &&
                     __float_as_uint(x) ==
                         __float_as_uint(
                             a.req[static_cast<size_t>(p - 1) * R + r]);
        }
      }
      const bool same_key = !first && pr == a.prio[p - 1] &&
                            g == a.group_idx[p - 1];
      uint32_t any = 0;
      for (int w = 0; w < TW; ++w) {
        const uint32_t bits = pack_word(a.untol, p, T, w);
        s_puntol[q * TW + w] = bits;
        any |= bits;
      }
      untol_any = untol_any || any != 0;
      s_pflag[q] = static_cast<uint8_t>(
          (same_key ? SAME_KEY : 0u) |
          (same_key && same_req ? SAME_REQ : 0u) |
          (a.active[p] ? ACTIVE : 0u) | (any ? UNTOL : 0u));
    }
    if (__syncthreads_or(untol_any) && !packed) {
      packed = true;
      for (int w = 0; live && w < TW; ++w) {
        const uint32_t bits = pack_word(a.taint, n, T, w);
        s_taint[w * TN + t] = bits;
        tainted = tainted || bits != 0;
      }
    }

    for (int q = 0; q < np; ++q) {
      const int p = p0 + q;
      const unsigned fl = s_pflag[q];
      bool taint_ok = true;
      if (live && tainted && (fl & UNTOL)) {
        for (int w = 0; w < TW; ++w) {
          if (s_puntol[q * TW + w] & s_taint[w * TN + t]) taint_ok = false;
        }
      }
      const bool act = (fl & ACTIVE) != 0;
      // overflow rows reachable by this pod: the caller escapes the pod
      const bool hit = live && over_n && valid_n && taint_ok && act;
      if (__any_sync(0xffffffffu, hit) && (t & 31) == 0) a.overflow[p] = 1;
      if (!live) continue;

      if (!(fl & SAME_KEY)) {
        // evict every lower-priority victim
        const int32_t pr = s_pprio[q];
        const int g = s_pgrp[q];
        elig = 0;
        for (int i = 0; i < k; ++i) {
          if (s_prio[i * TN + t] < pr) elig |= 1u << i;
        }
        float freed[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) freed[r] = 0.f;
        freed_np = 0.f;
        for (uint32_t m = elig; m; m &= m - 1) {
          const int i = __ffs(m) - 1;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < R) freed[r] = freed[r] + s_req[(i * R + r) * TN + t];
          }
          freed_np = freed_np + 1.f;
        }
        const size_t nr = static_cast<size_t>(n) * R;
        const float* nom = a.nom_used + (static_cast<size_t>(g) * N + n) * R;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) {
            const float eff = a.used[nr + r] + nom[r];
            fr0[r] = (a.alloc[nr + r] - eff) + freed[r];
          }
        }
        const float eff_np =
            a.npods[n] + a.nom_np[static_cast<size_t>(g) * N + n];
        slack0 = a.maxpods[n] - (eff_np - freed_np);
      }

      if (!(fl & SAME_REQ)) {
        float rq[RB], fr[RB];
        bool fits = true;
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) {
            rq[r] = s_preq[q * R + r];
            fr[r] = fr0[r];
            fits = fits && (rq[r] <= fr0[r] + EPS);
          }
        }
        fit_b = fits && slack0 >= 1.f && valid_n && freed_np > 0.f;

        // greedy reprieve: keep each victim the pod still fits with; once
        // the slack forbids one it forbids every later one
        uint32_t repr = 0;
        float slack = slack0;
        for (int s = 0; s < k && elig; ++s) {
          if (!((slack - 1.f) >= 1.f)) break;
          const int i = s_ord[s * TN + t];
          if (!((elig >> i) & 1u)) continue;
          bool ok = true;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < R) {
              const float ft = fr[r] - s_req[(i * R + r) * TN + t];
              ok = ok && (rq[r] <= ft + EPS);
            }
          }
          if (ok) {
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r < R) fr[r] = fr[r] - s_req[(i * R + r) * TN + t];
            }
            slack = slack - 1.f;
            repr |= 1u << i;
          }
        }

        nv = 0.f;
        vi = 0.f;
        ps = 0.f;
        hi = -I32_MAX;
        word = 0;
        for (uint32_t m = elig & ~repr; m; m &= m - 1) {
          const int i = __ffs(m) - 1;
          const int32_t pv = s_prio[i * TN + t];
          nv = nv + 1.f;
          vi = vi + s_pdb[i * TN + t];
          ps = ps + __int2float_rn(pv);
          hi = max(hi, pv);
          word |= 1u << s_slot[i * TN + t];
        }
        if (!(nv > 0.f)) hi = 0;
      }

      const size_t o = static_cast<size_t>(p) * N + n;
      a.cand[o] = (fit_b && taint_ok && act && nv > 0.f && !over_n) ? 1 : 0;
      a.viol[o] = vi;
      a.highest[o] = hi;
      a.psum[o] = ps;
      a.nvic[o] = nv;
      a.victims[o] = word;
    }
  }
}

// The block for (K, R, TW): its node rows, its shared bytes (allowed for
// the kernel) and the blocks of it an SM holds.
template <int RB, bool EXACT>
cudaError_t configure(int K, int R, int TW, int* tn, size_t* smem,
                      int* per_sm) {
  *tn = block_nodes(K, R, TW);
  if (*tn == 0) return cudaErrorInvalidValue;
  *smem = Layout(*tn, K, R, TW).total;
  const cudaError_t err = cudaFuncSetAttribute(
      dry_run_kernel<RB, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, dry_run_kernel<RB, EXACT>, *tn, *smem);
}

// The grid: one block per tn node rows, and along y the pods split.  When
// every node block is resident at once (blocks an SM x SMs), a block walks
// all P pods, so each node's slots are compacted once; otherwise the pods
// split into 64-pod ranges, so that the many rounds of blocks balance.
// a.ppb > 0 imposes the pods a block walks instead.
template <int RB, bool EXACT>
cudaError_t launch(Args a, cudaStream_t st) {
  int tn = 0, per_sm = 0, dev = 0, sms = 0;
  size_t smem = 0;
  cudaError_t err = configure<RB, EXACT>(a.K, a.R, a.TW, &tn, &smem, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int nx = cdiv(a.N, tn);
  if (a.ppb == 0) a.ppb = nx <= per_sm * sms ? a.P : PP;
  if (cdiv(a.P, a.ppb) > 65535) return cudaErrorInvalidValue;
  const dim3 grid(nx, cdiv(a.P, a.ppb));
  dry_run_kernel<RB, EXACT><<<grid, tn, smem, st>>>(a);
  return cudaGetLastError();
}

template <int RB, bool EXACT>
cudaError_t occupancy(int R, int K, int TW, int* out) {
  int tn = 0, per_sm = 0;
  size_t smem = 0;
  cudaFuncAttributes attr;
  cudaError_t err = configure<RB, EXACT>(K, R, TW, &tn, &smem, &per_sm);
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, dry_run_kernel<RB, EXACT>);
  }
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(smem);
  out[2] = tn;
  out[3] = per_sm;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

inline bool shape_ok(int P, int N, int V, int R, int G, int T, int K) {
  return P > 0 && N > 0 && V >= 1 && V <= V_MAX && R >= 1 && R <= R_MAX &&
         G >= 1 && T >= 0 && T <= 32 * TW_MAX && K >= 0 && K <= V &&
         P <= 65535 * PP;
}

}  // namespace

extern "C" {

int preempt_max_resources() { return R_MAX; }

int preempt_max_taints() { return 32 * TW_MAX; }

// Launch the dry run on `stream`.  Bool planes are uint8 0/1; taint [N, T]
// and untol [P, T] are the 0/1 f32 taint planes; K is the shared-memory
// capacity in live slots a node: at least the largest count of slots of a
// node whose priority is below I32_MAX (a node with more traps).  ppb: the
// pods a block walks, 0 for the grid rule of launch().  Returns the
// cudaError_t of the launch (0 on success); nothing is synchronised here.
int preempt_dry_run_launch(
    const float* alloc, const float* used, const float* npods,
    const float* maxpods, const uint8_t* valid, const float* taint,
    const int32_t* vict_prio, const float* vict_req, const float* vict_pdb,
    const uint8_t* vict_over, const float* nom_used, const float* nom_np,
    const int32_t* group_idx, const float* req, const int32_t* prio,
    const float* untol, const uint8_t* active, int P, int N, int V, int R,
    int G, int T, int K, int ppb, uint8_t* cand, float* viol, int32_t* highest,
    float* psum, float* nvic, uint32_t* victims, uint8_t* overflow,
    void* stream) {
  if (!shape_ok(P, N, V, R, G, T, K) || ppb < 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(overflow, 0, P, st);
  if (err != cudaSuccess) return err;
  const Args a{alloc,     used,     npods,     maxpods,   valid,    taint,
               vict_prio, vict_req, vict_pdb,  vict_over, nom_used, nom_np,
               group_idx, req,      prio,      untol,     active,   P,
               N,         V,        R,         T,         cdiv(T, 32),
               K,         ppb,      cand,      viol,      highest,  psum,
               nvic,      victims,  overflow};
  if (R == 6) return launch<6, true>(a, st);
  if (R <= 4) return launch<4, false>(a, st);
  if (R <= 8) return launch<8, false>(a, st);
  return launch<16, false>(a, st);
}

// The launch configuration and occupancy for (R, T, K):
// out[0] registers a thread, out[1] dynamic shared bytes a block, out[2]
// threads (node rows) a block, out[3] resident blocks an SM, out[4] local
// (spill) bytes a thread.  Returns a cudaError_t.
int preempt_occupancy(int R, int T, int K, int* out) {
  if (!shape_ok(1, 1, V_MAX, R, 1, T, K)) return cudaErrorInvalidValue;
  const int TW = cdiv(T, 32);
  if (R == 6) return occupancy<6, true>(R, K, TW, out);
  if (R <= 4) return occupancy<4, false>(R, K, TW, out);
  if (R <= 8) return occupancy<8, false>(R, K, TW, out);
  return occupancy<16, false>(R, K, TW, out);
}

}  // extern "C"

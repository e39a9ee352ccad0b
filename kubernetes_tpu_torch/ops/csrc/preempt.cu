// preempt: K7, the batched DryRunPreemption, one thread per (pod, node).
//
// Replaces the jit-compiled device program kubernetes_tpu/models/preempt.py
// (_preempt_dry_run :124-209).  Per (pod, node): evict every victim of lower
// priority than the pod, fit-check the pod on what is left (resources, pod
// count, taints, the capacity nominated pods claim), then re-add the victims
// one by one in the node's reprieve order (PDB-covered first, then highest
// priority, then slot) keeping each one the pod still fits with.  Same
// outputs as the JAX program: cand (uint8 0/1), viol, highest, psum, nvic
// per (pod, node) and overflow_hit per pod, except that the victims come as
// one 32-bit word per (pod, node), bit v = slot v (ops/flatten.py fills at
// most v_cap <= 32 slots a node); models/preempt.py expands the words.
//
// What bounds it.  Per cell it reads nothing new but the pod's nominated
// claim on the node (the node's slots are staged once per block) and writes
// 21 bytes (five planes and the word), and it computes V compares, V x R
// adds for the freed resources and up to V x R subtracts and compares for
// the reprieve walk.  At the main path's chunk (P = 256 pods x N = 110,080
// node rows, V = 16, R = 6) the outputs are ~0.6 GB: memory bound at
// ~0.18 ms on an H100 unless the walk costs more (chip_smoke.py computes
// both bounds from the run's inputs).
//
// Design (simple and right first).  A block takes TN node rows, one per
// thread, and a run of PP pods, which each thread walks in turn:
//   * the TN nodes' victim slots (priority, PDB bit, request vector) are
//     copied once into shared memory with coalesced reads, stored node-minor
//     ([slot][TN]), so that the threads of a warp read 32 consecutive words
//     whatever slot each of them needs: no bank conflict;
//   * each thread sorts its node's slots into the reprieve order once
//     (insertion sort, V <= 32) into its column of the order table;
//   * per pod, the eligibility mask, the freed resources, the fit test and
//     the V-step walk run in registers (R is bounded by a template
//     parameter, so the R-vectors stay in registers);
//   * the pod's request, priority, group and untolerated-taint bits are the
//     same address for every thread (broadcast loads);
//   * the planes are written at p * N + n: consecutive threads, consecutive
//     addresses;
//   * overflow_hit is a warp vote; lane 0 of a warp that saw a hit stores 1
//     (the launch zeroes the plane first).
//
// Numerics, held bit for bit against the JAX program as XLA compiles it on
// the CPU (models/preempt.py): every sum over slots runs in ascending slot
// order from +0 (that is XLA's order there); products are by 0/1 weights;
// the build passes -fmad=false, so nothing is contracted; the int32 -> f32
// conversion of a priority rounds to nearest.  The taint test compares bit
// masks: the JAX program's einsum of two 0/1 planes is 0 exactly when no
// bit is common.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int PP = 64;            // pods per block
constexpr int V_MAX = 32;         // victim slots (one bit each in the word)
constexpr int R_MAX = 16;         // resource columns
constexpr int TN_MAX = 128;       // node rows per block (threads)
constexpr size_t SMEM_TARGET = 96 * 1024;  // keep >= 2 blocks an SM
constexpr float EPS = 1e-6f;
constexpr int32_t I32_MAX = 2147483647;

struct Args {
  const float* alloc;        // [N, R]
  const float* used;         // [N, R]
  const float* npods;        // [N]
  const float* maxpods;      // [N]
  const uint8_t* valid;      // [N]
  const uint32_t* taint_bits;  // [N, TW]
  const int32_t* vict_prio;  // [N, V]
  const float* vict_req;     // [N, V, R]
  const float* vict_pdb;     // [N, V]
  const uint8_t* vict_over;  // [N]
  const float* nom_used;     // [G, N, R]
  const float* nom_np;       // [G, N]
  const int32_t* group_idx;  // [P]
  const float* req;          // [P, R]
  const int32_t* prio;       // [P]
  const uint32_t* untol_bits;  // [P, TW]
  const uint8_t* active;     // [P]
  int P, N, V, R, TW;
  uint8_t* cand;             // [P, N] outputs
  float* viol;
  int32_t* highest;
  float* psum;
  float* nvic;
  uint32_t* victims;
  int32_t* overflow;         // [P]
};

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// shared bytes a block of tn node rows uses: priority, PDB bit and request
// vector of every slot, and the order table
inline size_t smem_bytes(int tn, int V, int R) {
  return static_cast<size_t>(tn) * V * (sizeof(int32_t) + sizeof(float)
                                        + sizeof(float) * R + 1);
}

// the widest block (a multiple of 32) whose slots fit SMEM_TARGET
inline int block_nodes(int V, int R) {
  int tn = TN_MAX;
  while (tn > 32 && smem_bytes(tn, V, R) > SMEM_TARGET) tn /= 2;
  return tn;
}

// reprieve order: (-pdb, -priority, slot) ascending, jnp.lexsort((slot,
// -prio, -pdb))'s order.  -prio is taken in 64 bits (no overflow).
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

template <int RB>
__global__ void __launch_bounds__(TN_MAX) dry_run_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TN = blockDim.x;
  const int V = a.V, R = a.R, N = a.N;
  int32_t* s_prio = reinterpret_cast<int32_t*>(smem);          // [V][TN]
  float* s_pdb = reinterpret_cast<float*>(s_prio + V * TN);    // [V][TN]
  float* s_req = s_pdb + V * TN;                               // [V*R][TN]
  uint8_t* s_ord = reinterpret_cast<uint8_t*>(s_req + V * R * TN);  // [V][TN]

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * TN;
  const int nn = min(TN, N - n0);
  const int n = n0 + t;
  const bool live = t < nn;

  // stage the block's slots: coalesced over the contiguous global rows
  {
    const size_t base = static_cast<size_t>(n0) * V;
    for (int i = t; i < nn * V; i += TN) {
      const int node = i / V, v = i - node * V;
      s_prio[v * TN + node] = a.vict_prio[base + i];
      s_pdb[v * TN + node] = a.vict_pdb[base + i];
    }
    const int VR = V * R;
    const size_t rbase = static_cast<size_t>(n0) * VR;
    for (int i = t; i < nn * VR; i += TN) {
      const int node = i / VR, k = i - node * VR;
      s_req[k * TN + node] = a.vict_req[rbase + i];
    }
  }
  __syncthreads();

  // this node's row, its reprieve order and its constants
  float alloc_r[RB], used_r[RB];
  float npods_n = 0.f, maxpods_n = 0.f;
  bool valid_n = false, over_n = false;
  if (live) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        alloc_r[r] = a.alloc[static_cast<size_t>(n) * R + r];
        used_r[r] = a.used[static_cast<size_t>(n) * R + r];
      }
    }
    npods_n = a.npods[n];
    maxpods_n = a.maxpods[n];
    valid_n = a.valid[n] != 0;
    over_n = a.vict_over[n] != 0;
    for (int s = 0; s < V; ++s) s_ord[s * TN + t] = static_cast<uint8_t>(s);
    for (int i = 1; i < V; ++i) {
      const int x = s_ord[i * TN + t];
      int j = i - 1;
      while (j >= 0 &&
             reprieve_before(x, s_ord[j * TN + t], s_prio, s_pdb, TN, t)) {
        s_ord[(j + 1) * TN + t] = s_ord[j * TN + t];
        --j;
      }
      s_ord[(j + 1) * TN + t] = static_cast<uint8_t>(x);
    }
  }

  const int p0 = blockIdx.y * PP;
  const int p1 = min(a.P, p0 + PP);
  for (int p = p0; p < p1; ++p) {
    const bool act = a.active[p] != 0;
    bool taint_ok = true;
    if (live) {
      for (int w = 0; w < a.TW; ++w) {
        if (a.untol_bits[static_cast<size_t>(p) * a.TW + w] &
            a.taint_bits[static_cast<size_t>(n) * a.TW + w]) {
          taint_ok = false;
        }
      }
    }
    // overflow rows reachable by this pod: the caller escapes the pod
    const bool hit = live && over_n && valid_n && taint_ok && act;
    if (__any_sync(0xffffffffu, hit) && (t & 31) == 0) a.overflow[p] = 1;
    if (!live) continue;

    const int32_t pr = a.prio[p];
    const int g = a.group_idx[p];
    float rq[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) rq[r] = a.req[static_cast<size_t>(p) * R + r];
    }

    // evict every lower-priority victim (a PAD slot's priority, I32_MAX,
    // is above any clamped real one)
    uint32_t elig = 0;
    for (int v = 0; v < V; ++v) {
      if (s_prio[v * TN + t] < pr) elig |= 1u << v;
    }
    float freed[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) freed[r] = 0.f;
    float freed_np = 0.f;
    for (int v = 0; v < V; ++v) {
      const float e = ((elig >> v) & 1u) ? 1.f : 0.f;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < R) freed[r] = freed[r] + e * s_req[(v * R + r) * TN + t];
      }
      freed_np = freed_np + e;
    }

    const float* nom = a.nom_used + (static_cast<size_t>(g) * N + n) * R;
    float fr[RB];
    bool fits = true;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        const float eff = used_r[r] + nom[r];
        fr[r] = (alloc_r[r] - eff) + freed[r];
        fits = fits && (rq[r] <= fr[r] + EPS);
      }
    }
    const float eff_np = npods_n + a.nom_np[static_cast<size_t>(g) * N + n];
    float slack = maxpods_n - (eff_np - freed_np);
    fits = fits && slack >= 1.f && valid_n && taint_ok && freed_np > 0.f &&
           act;

    // greedy reprieve: keep each victim the pod still fits with
    uint32_t repr = 0;
    for (int s = 0; s < V; ++s) {
      const int j = s_ord[s * TN + t];
      if (!((elig >> j) & 1u)) continue;
      bool ok = (slack - 1.f) >= 1.f;
      float ft[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < R) {
          ft[r] = fr[r] - s_req[(j * R + r) * TN + t];
          ok = ok && (rq[r] <= ft[r] + EPS);
        }
      }
      if (ok) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) fr[r] = ft[r];
        }
        slack = slack - 1.f;
        repr |= 1u << j;
      }
    }

    const uint32_t vict = elig & ~repr;
    float nv = 0.f, vi = 0.f, ps = 0.f;
    int32_t hi = -I32_MAX;
    for (int v = 0; v < V; ++v) {
      const bool on = (vict >> v) & 1u;
      const float f = on ? 1.f : 0.f;
      const int32_t pv = s_prio[v * TN + t];
      nv = nv + f;
      vi = vi + f * s_pdb[v * TN + t];
      ps = ps + f * __int2float_rn(pv);
      if (on && pv > hi) hi = pv;
    }
    if (!(nv > 0.f)) hi = 0;
    const size_t o = static_cast<size_t>(p) * N + n;
    a.cand[o] = (fits && nv > 0.f && !over_n) ? 1 : 0;
    a.viol[o] = vi;
    a.highest[o] = hi;
    a.psum[o] = ps;
    a.nvic[o] = nv;
    a.victims[o] = vict;
  }
}

template <int RB>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int tn = block_nodes(a.V, a.R);
  const size_t smem = smem_bytes(tn, a.V, a.R);
  cudaError_t err = cudaFuncSetAttribute(
      dry_run_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(a.N, tn), cdiv(a.P, PP));
  dry_run_kernel<RB><<<grid, tn, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int preempt_max_resources() { return R_MAX; }

// Launch the dry run on `stream`.  Bool planes are uint8 0/1; taint_bits
// [N, TW] and untol_bits [P, TW] are the 0/1 taint planes packed 32 to a
// word.  Returns the cudaError_t of the launch (0 on success); nothing is
// synchronised here.
int preempt_dry_run_launch(
    const float* alloc, const float* used, const float* npods,
    const float* maxpods, const uint8_t* valid, const uint32_t* taint_bits,
    const int32_t* vict_prio, const float* vict_req, const float* vict_pdb,
    const uint8_t* vict_over, const float* nom_used, const float* nom_np,
    const int32_t* group_idx, const float* req, const int32_t* prio,
    const uint32_t* untol_bits, const uint8_t* active, int P, int N, int V,
    int R, int G, int TW, uint8_t* cand, float* viol, int32_t* highest,
    float* psum, float* nvic, uint32_t* victims, int32_t* overflow,
    void* stream) {
  if (P <= 0 || N <= 0 || V < 1 || V > V_MAX || R < 1 || R > R_MAX ||
      G < 1 || TW < 0 || P > 65535 * PP) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(overflow, 0, sizeof(int32_t) * P, st);
  if (err != cudaSuccess) return err;
  const Args a{alloc,     used,      npods,     maxpods,  valid,    taint_bits,
               vict_prio, vict_req,  vict_pdb,  vict_over, nom_used, nom_np,
               group_idx, req,       prio,      untol_bits, active,  P,
               N,         V,         R,         TW,       cand,     viol,
               highest,   psum,      nvic,      victims,  overflow};
  if (R <= 4) return launch<4>(a, st);
  if (R <= 8) return launch<8>(a, st);
  return launch<16>(a, st);
}

}  // extern "C"

// claims: fused resource-fit mask + LeastAllocated/BalancedAllocation score
// + tie-break noise + per-pod first-index argmax over the node axis.
//
// Replaces the Pallas TPU kernel kubernetes_tpu/ops/pallas_kernels.py
// (_claims_kernel :76-142, claims :171-217).  Same outputs: claims int32[P]
// (-1 when no node is feasible) and best f32[P] (NEG when none is).
//
// Layout.  The static mask arrives as uint8 [N, ld] (node-major), ld = P
// rounded up to a multiple of 16 (ops/kernels.py prepare_static pads the
// columns with 0, i.e. infeasible), so every pod group's bytes of a node
// row are one aligned 4-, 8- or 16-byte load.
//
// Design.  The TPU kernel walks a sequential (pod tile, node tile) grid and
// carries a running (best, index) pair in VMEM scratch.  Hopper blocks run
// in no order, so the node axis is cut into slices, one per blockIdx.y, and
// a second kernel folds the slices in ascending order with the strict rule
// below.  Inside a block:
//   * each thread owns PT adjacent pods (a register tile) and keeps each
//     pod's (best, idx) in registers, walking the slice's nodes in
//     ascending order and moving only on a strictly greater value: the
//     first index of the slice's maximum.  The fold keeps that rule, so the
//     result is the lowest node index among the global maxima, exactly the
//     TPU kernel's tie rule;
//   * the slice's node rows are staged TNS nodes at a time in shared memory
//     as a node-major struct (avail[R], used_nz cpu/mem, the two utilization
//     divisors), read with 16-byte broadcast loads: one node's values serve
//     the thread's PT cells;
//   * the mask bytes of a node for the thread's PT pods are one vector load
//     from [TN nodes x block pods] tiles that cp.async stages in shared
//     memory in a ring of STAGES buffers, the next tile's copy in flight
//     while this one is scored (faster on an H100 than vector loads straight
//     from device memory, PERF.md);
//   * R is a template parameter (2..R_MAX), so the fit test is R compares
//     in registers;
//   * when every thread's pods request the same resources (replica pods,
//     the common batch), fit and score depend on the node alone: they are
//     computed once per node and shared by the PT pods (exact: the same
//     operations on the same operands);
//   * a block whose pods are all inactive writes NEG/-1 partials and
//     returns after one vote, before it stages anything;
//   * the slice width is chosen from P, N and the SM count so that both the
//     wave launch (P=16384) and the compacted tail (P=512) put several
//     blocks on every SM.
//
// The noise prune, and why it is exact.  A cell's value is
// v = fl(score + noise) with 0 <= noise <= NOISE_MAX, where NOISE_MAX is
// the largest value the noise rule can return (sin: fract <= 1 after
// rounding, times 1e-3f, so 1e-3f; murmur: (2^24-1) * scale).  Round to
// nearest is monotone, so v <= upper = fl(score + NOISE_MAX).  When
// upper <= best, with best the pod's running best of this slice, v <= best
// and the strict update v > best cannot fire: skipping the noise leaves
// claims and best bit-identical.  (The comparison is written so that a NaN
// score is never skipped.)  The slices also share, per pod, the best cell
// any of them has published (a 64-bit atomicMax of value, then lower
// index): a published cell (w, m) beats a cell of this slice whose upper
// bound is below w, or equal to w when m lies in an earlier slice, so those
// cells skip the noise as well.  That cell is never the answer, and the
// answer's own cell is never skipped (no other cell beats it), so its slice
// still reports it and the fold still finds it.  On the bench inputs the
// noise is the kernel's cost: with scores tiered by load the prune leaves it
// to the top tier's cells; where nodes tie (an empty cluster), to the cells
// before each pod's first cell at the top noise value.
//
// Numerics: every f32 operation is written as an explicitly rounded
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, __fmaf_rn), so neither the
// compiler's contraction nor an approximate division can change a score;
// build with -fmad=false and without --use_fast_math as well.  The two
// fused multiply-adds sit exactly where XLA, compiling the JAX reference on
// the CPU, contracts a*b + c*d (measured): the score's first product, and
// the sin argument's node term.  That keeps the murmur rule bit-identical to
// the reference's XLA wave body.  sin is taken in f64 and rounded: f32
// sin of arguments up to ~9e6 is not reproducible bit for bit between
// implementations (see kernels.py), the correctly rounded value is.
//
// Bound on an H100 at the bench shape (P=16384, N=110080): 1 byte of mask
// per cell (1.8 GB, ~0.54 ms at 3.35 TB/s).  The operations the inputs
// need are a mask test per cell, fit and score once per distinct (pod
// request, node) pair, and the noise (~12 f32 and ~20 f64 operations for
// sin) only on the cells that could still beat the answer; on the bench
// inputs they come to less than the bytes' time.  chip_smoke.py computes
// the bounds from the run's inputs.  Without the noise the kernel runs
// near the mask's bytes; the noise (the f64 sin above all) takes the rest
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// The tuning, each the fastest of the values timed side by side on an H100
// (PERF.md): pods per thread (of 4, 8, 16), the grid's target in blocks per
// SM (of 4, 8, 16) and its cap in node slices.
constexpr int PT = 8;
constexpr int BLOCKS_PER_SM = 16;
constexpr int MAX_SLICES = 512;
constexpr int THREADS = 128;    // most threads per block
constexpr int TNS = 128;        // nodes per staged node-row tile
constexpr int TN = 256 / PT;    // nodes per mask tile: 32 KB at 128 threads
static_assert(TNS % TN == 0, "a mask tile lies inside one node-row tile");
constexpr int STAGES = 2;       // mask tiles in the ring
constexpr int R_MAX = 16;       // resource columns a pod keeps in registers
constexpr int LD_ALIGN = 16;    // mask row stride granule, bytes
constexpr float NEG = -1e9f;
constexpr float SIN_NOISE = 1e-3f;                   // pallas_kernels.TIE_NOISE
constexpr float MURMUR_SCALE = 0.05f / 16777216.0f;  // assign.TIE_NOISE / 2^24

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int round_up(int a, int b) {
  return cdiv(a, b) * b;
}

// pods per thread for R resources: the general path keeps PT * R requests
// in registers, so wide R halves the tile
__host__ __device__ constexpr int pt_for(int R) {
  return (R <= 8 || PT == 4) ? PT : PT / 2;
}

// floats per staged node row: avail[R], used_nz cpu, used_nz mem, and the
// cpu/mem divisors (max(alloc, 1) when alloc > 0, else -1), padded to 16 B
__host__ __device__ constexpr int node_floats(int R) {
  return round_up(R + 4, 4);
}

// -------------------------------------------------------------- noise ----

// sin(gp*12.9898 + gn*78.233)*43758.5453, fract, * 1e-3, where
// kp = gp * 12.9898 is the pod's half of the argument
__device__ __forceinline__ float sin_noise(float kp, int node) {
  const float gn = static_cast<float>(node);
  // fma(gn, 78.233, gp * 12.9898): the reference's compiled form
  const float arg = __fmaf_rn(gn, 78.233f, kp);
  // the correctly rounded f32 sin, through f64: the plain version takes
  // the same route, so the two agree bit for bit
  const float s = __double2float_rn(sin(static_cast<double>(arg)));
  const float h = __fmul_rn(s, 43758.5453f);
  return __fmul_rn(__fsub_rn(h, floorf(h)), SIN_NOISE);
}

// the same, out of line, for the sparse loop
__device__ __noinline__ float sin_noise_call(float kp, int node) {
  return sin_noise(kp, node);
}

// murmur3 finalizer of (pod * 0x9E3779B1) ^ (node * 0x85EBCA77); kh and nh
// are the two products
__device__ __forceinline__ float murmur_noise(uint32_t kh, uint32_t nh) {
  uint32_t hx = kh ^ nh;
  hx ^= hx >> 16;
  hx *= 0x85EBCA6Bu;
  hx ^= hx >> 13;
  hx *= 0xC2B2AE35u;
  hx ^= hx >> 16;
  return __fmul_rn(static_cast<float>(hx >> 8), MURMUR_SCALE);
}

// ------------------------------------------------------------- scores ----

// util = a > 0 ? min(u / max(a, 1), 1) : 1   (assign._fit_scores_vec), with
// d = max(a, 1) when a > 0 and -1 otherwise, precomputed per node
__device__ __forceinline__ float utilization(float used_nz, float req_nz,
                                             float d) {
  const float u = __fadd_rn(used_nz, req_nz);
  return d > 0.0f ? fminf(__fdiv_rn(u, d), 1.0f) : 1.0f;
}

// (2 - ucpu - umem) * 50 + (1 - |ucpu - umem| * 0.5) * 100, the first
// product fused into the sum as the reference compiles it
__device__ __forceinline__ float fit_score(float ucpu, float umem) {
  const float balanced = __fmul_rn(
      __fsub_rn(1.0f, __fmul_rn(fabsf(__fsub_rn(ucpu, umem)), 0.5f)), 100.0f);
  return __fmaf_rn(__fsub_rn(__fsub_rn(2.0f, ucpu), umem), 50.0f, balanced);
}

// --------------------------------------------------------------- mask ----

// a thread's PT mask bytes of one node, as PT/4 words
template <int K>
struct MaskWords {
  uint32_t w[K / 4];
};

template <int K>
__device__ __forceinline__ MaskWords<K> load_mask_shared(const uint8_t* p) {
  MaskWords<K> m;
  if constexpr (K == 4) {
    m.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (K == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    m.w[0] = v.x;
    m.w[1] = v.y;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    m.w[0] = v.x;
    m.w[1] = v.y;
    m.w[2] = v.z;
    m.w[3] = v.w;
  }
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------- pod state ----

template <int R, int K, bool MURMUR>
struct Pods {
  float rq[K][R];          // requests (general path)
  float rzc[K], rzm[K];    // non-zero requests, cpu and mem
  float ref_rq[R];         // the first live pod's requests (SAME path)
  float ref_zc, ref_zm;
  float kp[K];             // sin: gp * 12.9898
  uint32_t kh[K];          // murmur: pod * 0x9E3779B1
  MaskWords<K> live;       // 0xff in the byte of every live pod
  float best[K];           // running (best, idx) of this slice
  int idx[K];
  float bar[K];            // prune threshold: a cell with upper <= bar loses
  float bar_min;           // min of bar over the live pods
  uint32_t dirty;          // pods whose best moved since the last publish
  bool any;                // some pod of this thread is live
  bool same;               // every live pod requests what the first does
};

// The slices share, per pod, the best cell any of them has published, as a
// 64-bit key ordered like the result: value, then the lower node index.
__device__ __forceinline__ unsigned long long record_key(float v, int n) {
  uint32_t u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(n));
}

// A published cell (v, m) beats every cell (w, n) with w < v, and with
// w == v when m < n.  So for this slice (nodes from n_lo up) a cell whose
// upper bound is <= v loses when m < n_lo, and one whose bound is below v
// (<= the next float down) loses otherwise.
__device__ __forceinline__ float record_bar(unsigned long long key,
                                            int n_lo) {
  if (key == 0) return -INFINITY;
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  const float v = __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
  const int m = static_cast<int>(~static_cast<uint32_t>(key));
  return m < n_lo ? v : nextafterf(v, -INFINITY);
}

// Publish this thread's improved bests and take in the other slices'.
template <int R, int K, bool MURMUR>
__device__ __forceinline__ void share_records(
    Pods<R, K, MURMUR>& ps, unsigned long long* __restrict__ rec, int p0,
    int n_lo) {
  float lo = INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (((ps.live.w[k >> 2] >> (8 * (k & 3))) & 0xffu) == 0) continue;
    if (ps.dirty & (1u << k))
      atomicMax(rec + p0 + k, record_key(ps.best[k], ps.idx[k]));
    const unsigned long long key =
        *reinterpret_cast<volatile unsigned long long*>(rec + p0 + k);
    ps.bar[k] = fmaxf(ps.bar[k], record_bar(key, n_lo));
    lo = fminf(lo, ps.bar[k]);
  }
  ps.bar_min = lo;
  ps.dirty = 0;
}

template <int K>
__device__ __forceinline__ bool byte_set(const MaskWords<K>& m, int k) {
  return ((m.w[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0;
}

// The noise of the cells in `need` (one bit per pod of the thread) and
// their strict running-max updates.  When a lane of the warp needs most
// of its slots (and always for the cheap murmur noise) every slot's noise
// is computed in straight-line code, the slots' chains interleaved;
// otherwise one needed cell per iteration, so that a warp runs as many
// sins per node as its busiest lane needs, not one per pod slot that any
// lane needs.  The choice only moves time: both ways are exact.
template <int R, int K, bool MURMUR>
__device__ __forceinline__ void add_noise(uint32_t need, const float* score,
                                          int n, uint32_t nh,
                                          Pods<R, K, MURMUR>& ps) {
  if (MURMUR || __any_sync(__activemask(), 2 * __popc(need) > K)) {
    // every slot's noise, unconditionally: straight-line code in which the
    // K independent chains interleave; the update takes the needed ones
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = __fadd_rn(score[k], MURMUR ? murmur_noise(ps.kh[k], nh)
                                        : sin_noise(ps.kp[k], n));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (((need >> k) & 1u) && v[k] > ps.best[k]) {
        ps.best[k] = v[k];
        ps.idx[k] = n;
        ps.bar[k] = fmaxf(ps.bar[k], v[k]);
        ps.dirty |= 1u << k;
      }
    }
    return;
  }
  while (need) {
    const int k = __ffs(need) - 1;
    need &= need - 1;
    float kp = 0.0f, sk = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j == k) {
        kp = ps.kp[j];
        sk = score[j];
      }
    const float v = __fadd_rn(sk, sin_noise_call(kp, n));
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j == k && v > ps.best[j]) {
        ps.best[j] = v;
        ps.idx[j] = n;
        ps.bar[j] = fmaxf(ps.bar[j], v);
        ps.dirty |= 1u << j;
      }
  }
}

// Score one node for the thread's pods.  f is the node's staged row;
// m the node's mask bytes already ANDed with the live bytes.  A cell whose
// upper bound is <= its pod's bar skips the noise (see the header).
template <int R, int K, bool MURMUR, bool SAME>
__device__ __forceinline__ void visit(const float* __restrict__ f,
                                      const MaskWords<K>& m, int n,
                                      uint32_t gn, float nmax,
                                      Pods<R, K, MURMUR>& ps) {
  constexpr int NF = node_floats(R);
  float row[NF];
#pragma unroll
  for (int j = 0; j < NF; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(f + j);
    row[j] = q.x;
    row[j + 1] = q.y;
    row[j + 2] = q.z;
    row[j + 3] = q.w;
  }
  const float* av = row;  // avail[R], then used_nz cpu/mem, d cpu/mem
  const float unz_c = row[R], unz_m = row[R + 1];
  const float d_c = row[R + 2], d_m = row[R + 3];
  float score[K];
  uint32_t need = 0;
  if constexpr (SAME) {
    bool fit = true;
#pragma unroll
    for (int r = 0; r < R; ++r) fit &= ps.ref_rq[r] <= av[r];
    if (!fit) return;
    const float sc = fit_score(utilization(unz_c, ps.ref_zc, d_c),
                               utilization(unz_m, ps.ref_zm, d_m));
    const float upper = __fadd_rn(sc, nmax);
    if (upper <= ps.bar_min) return;  // every pod's bar beats this node
#pragma unroll
    for (int k = 0; k < K; ++k) {
      score[k] = sc;
      if (byte_set(m, k) && !(upper <= ps.bar[k])) need |= 1u << k;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      score[k] = 0.0f;
      if (!byte_set(m, k)) continue;
      bool fit = true;
#pragma unroll
      for (int r = 0; r < R; ++r) fit &= ps.rq[k][r] <= av[r];
      if (!fit) continue;
      score[k] = fit_score(utilization(unz_c, ps.rzc[k], d_c),
                           utilization(unz_m, ps.rzm[k], d_m));
      if (!(__fadd_rn(score[k], nmax) <= ps.bar[k])) need |= 1u << k;
    }
  }
  add_noise(need, score, n, gn * 0x85EBCA77u, ps);
}

template <int K>
__device__ __forceinline__ bool and_any(MaskWords<K>& m,
                                        const MaskWords<K>& live) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < K / 4; ++j) {
    m.w[j] &= live.w[j];
    acc |= m.w[j];
  }
  return acc != 0;
}

// stage node n's row: avail = alloc - used (avail[0] = NaN when the pod
// cap is reached, which fails every fit compare: cap_ok && fit is then
// false, as in the reference), used_nz cpu/mem, the utilization divisors
template <int R>
__device__ __forceinline__ void stage_node(
    float* __restrict__ dst, int n, const float* __restrict__ alloc,
    const float* __restrict__ used, const float* __restrict__ used_nz,
    const float* __restrict__ npods, const float* __restrict__ maxpods) {
  const float* a = alloc + static_cast<size_t>(n) * R;
  const float* u = used + static_cast<size_t>(n) * R;
#pragma unroll
  for (int r = 0; r < R; ++r) dst[r] = __fsub_rn(a[r], u[r]);
  if (!(__fadd_rn(npods[n], 1.0f) <= maxpods[n]))
    dst[0] = __int_as_float(0x7fc00000);
  dst[R] = used_nz[static_cast<size_t>(n) * R + 0];
  dst[R + 1] = used_nz[static_cast<size_t>(n) * R + 1];
  dst[R + 2] = a[0] > 0.0f ? fmaxf(a[0], 1.0f) : -1.0f;
  dst[R + 3] = a[1] > 0.0f ? fmaxf(a[1], 1.0f) : -1.0f;
}

// The slice loop of one block, for one path (SAME or general).
template <int R, int K, bool MURMUR, bool SAME>
__device__ __forceinline__ void run_slice(
    Pods<R, K, MURMUR>& ps, unsigned char* smem, const float* alloc,
    const float* used, const float* used_nz, const float* npods,
    const float* maxpods, const uint8_t* __restrict__ smask_t, int ld,
    int p_blk, int p0, int n_lo, int n_hi, int node_offset, float nmax,
    unsigned long long* __restrict__ rec) {
  constexpr int NF = node_floats(R);
  float* s_node = reinterpret_cast<float*>(smem);
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  uint8_t* s_mask = smem + TNS * NF * sizeof(float);
  const int row = tpb * K;                  // mask bytes per node in a tile
  const int chunks = row / 16;              // 16-byte copies per node row
  const int live_chunks = min(chunks, (ld - p_blk) / 16);
  const int ntiles = cdiv(n_hi - n_lo, TN);
  auto issue = [&](int t) {
    if (t < ntiles) {
      const int nt0 = n_lo + t * TN;
      const int tn = min(TN, n_hi - nt0);
      uint8_t* dst = s_mask + (t % STAGES) * TN * row;
      for (int c = tid; c < tn * chunks; c += tpb) {
        const int i = c / chunks, j = c - i * chunks;
        if (j < live_chunks)
          cp_async16(dst + i * row + j * 16,
                     smask_t + static_cast<size_t>(nt0 + i) * ld + p_blk +
                         j * 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int t = 0; t < ntiles; ++t) {
    issue(t + STAGES - 1);  // its buffer's readers passed the last barrier
    const int nt0 = n_lo + t * TN;
    const int tn = min(TN, n_hi - nt0);
    const int off = (nt0 - n_lo) % TNS;
    if (off == 0) {
      const int ns = min(TNS, n_hi - nt0);
      for (int i = tid; i < ns; i += tpb)
        stage_node<R>(s_node + i * NF, nt0 + i, alloc, used, used_nz, npods,
                      maxpods);
      if (ps.any) share_records(ps, rec, p0, n_lo);
    }
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    if (ps.any) {
      const uint8_t* tile = s_mask + (t % STAGES) * TN * row + tid * K;
      for (int i = 0; i < tn; ++i) {
        MaskWords<K> m = load_mask_shared<K>(tile + i * row);
        if (and_any(m, ps.live))
          visit<R, K, MURMUR, SAME>(
              s_node + (off + i) * NF, m, nt0 + i,
              static_cast<uint32_t>(node_offset + nt0 + i), nmax, ps);
      }
    }
    __syncthreads();
  }
}

template <int R, int K, bool MURMUR>
__global__ void __launch_bounds__(THREADS) claims_slice_kernel(
    const float* __restrict__ req, const float* __restrict__ req_nz,
    const uint8_t* __restrict__ active, const int32_t* __restrict__ pod_ids,
    const float* __restrict__ alloc, const float* __restrict__ used,
    const float* __restrict__ used_nz, const float* __restrict__ npods,
    const float* __restrict__ maxpods, const uint8_t* __restrict__ smask_t,
    int P, int N, int slice_w, int node_offset,
    float* __restrict__ part_best, int32_t* __restrict__ part_idx,
    unsigned long long* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = round_up(P, LD_ALIGN);
  const int p_blk = blockIdx.x * blockDim.x * K;
  const int p0 = p_blk + threadIdx.x * K;
  const int n_lo = blockIdx.y * slice_w;
  const int n_hi = min(N, n_lo + slice_w);

  Pods<R, K, MURMUR> ps;
  ps.any = false;
  ps.same = true;
  ps.ref_zc = ps.ref_zm = 0.0f;
  ps.dirty = 0;
  ps.bar_min = NEG;
#pragma unroll
  for (int j = 0; j < K / 4; ++j) ps.live.w[j] = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = p0 + k;
    const bool live = p < P && active[p] != 0;
    ps.best[k] = ps.bar[k] = NEG;
    ps.idx[k] = -1;
#pragma unroll
    for (int r = 0; r < R; ++r)
      ps.rq[k][r] = live ? req[static_cast<size_t>(p) * R + r] : 0.0f;
    ps.rzc[k] = live ? req_nz[static_cast<size_t>(p) * R + 0] : 0.0f;
    ps.rzm[k] = live ? req_nz[static_cast<size_t>(p) * R + 1] : 0.0f;
    const int key = live ? pod_ids[p] : 0;
    ps.kp[k] = __fmul_rn(static_cast<float>(key), 12.9898f);
    ps.kh[k] = static_cast<uint32_t>(key) * 0x9E3779B1u;
    if (!live) continue;
    ps.live.w[k >> 2] |= 0xffu << (8 * (k & 3));
    if (!ps.any) {
#pragma unroll
      for (int r = 0; r < R; ++r) ps.ref_rq[r] = ps.rq[k][r];
      ps.ref_zc = ps.rzc[k];
      ps.ref_zm = ps.rzm[k];
    } else {
      // bit patterns: the SAME path must see the very same operands
      bool eq = __float_as_uint(ps.rzc[k]) == __float_as_uint(ps.ref_zc) &&
                __float_as_uint(ps.rzm[k]) == __float_as_uint(ps.ref_zm);
#pragma unroll
      for (int r = 0; r < R; ++r)
        eq = eq &&
             __float_as_uint(ps.rq[k][r]) == __float_as_uint(ps.ref_rq[r]);
      ps.same = ps.same && eq;
    }
    ps.any = true;
  }
  // the block's one decision before any tile: is any of its pods live
  if (!__syncthreads_or(ps.any)) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = p0 + k;
      if (p < P) {
        part_best[static_cast<size_t>(blockIdx.y) * P + p] = NEG;
        part_idx[static_cast<size_t>(blockIdx.y) * P + p] = -1;
      }
    }
    return;
  }
  const float nmax = MURMUR ? __fmul_rn(16777215.0f, MURMUR_SCALE) : SIN_NOISE;
  if (__syncthreads_and(ps.same || !ps.any)) {
    run_slice<R, K, MURMUR, true>(ps, smem, alloc, used, used_nz, npods,
                                  maxpods, smask_t, ld, p_blk, p0, n_lo,
                                  n_hi, node_offset, nmax, rec);
  } else {
    run_slice<R, K, MURMUR, false>(ps, smem, alloc, used, used_nz, npods,
                                   maxpods, smask_t, ld, p_blk, p0, n_lo,
                                   n_hi, node_offset, nmax, rec);
  }
  if (ps.any) share_records(ps, rec, p0, n_lo);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = p0 + k;
    if (p < P) {
      part_best[static_cast<size_t>(blockIdx.y) * P + p] = ps.best[k];
      part_idx[static_cast<size_t>(blockIdx.y) * P + p] = ps.idx[k];
    }
  }
}

// Fold the slices' partials in ascending slice order with the strict
// rule: FOLD_CHUNKS threads per pod each fold a contiguous run of slices,
// then the first folds the runs in order (the rule is associative, so this
// is the one sequential fold).
constexpr int FOLD_PODS = 32;
constexpr int FOLD_CHUNKS = 8;

__global__ void __launch_bounds__(FOLD_PODS * FOLD_CHUNKS)
claims_fold_kernel(const float* __restrict__ part_best,
                   const int32_t* __restrict__ part_idx, int P, int N, int S,
                   int32_t* __restrict__ claims,
                   float* __restrict__ best_out) {
  __shared__ float s_best[FOLD_CHUNKS][FOLD_PODS];
  __shared__ int s_idx[FOLD_CHUNKS][FOLD_PODS];
  const int pp = threadIdx.x % FOLD_PODS;
  const int c = threadIdx.x / FOLD_PODS;
  const int p = blockIdx.x * FOLD_PODS + pp;
  const int run = cdiv(S, FOLD_CHUNKS);
  float best = NEG;
  int idx = -1;
  if (p < P) {
    const int s_hi = min(S, (c + 1) * run);
#pragma unroll 4
    for (int s = c * run; s < s_hi; ++s) {
      const float v = part_best[static_cast<size_t>(s) * P + p];
      if (v > best) {
        best = v;
        idx = part_idx[static_cast<size_t>(s) * P + p];
      }
    }
  }
  s_best[c][pp] = best;
  s_idx[c][pp] = idx;
  __syncthreads();
  if (c != 0 || p >= P) return;
#pragma unroll
  for (int j = 1; j < FOLD_CHUNKS; ++j) {
    if (s_best[j][pp] > best) {
      best = s_best[j][pp];
      idx = s_idx[j][pp];
    }
  }
  claims[p] = (best > NEG / 2 && idx < N) ? idx : -1;
  best_out[p] = best;
}

// ---------------------------------------------------------------- host ----

int device_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

int block_threads(int P, int K) {
  return std::min(THREADS, round_up(cdiv(P, K), 32));
}

// nodes per slice: enough slices that the pod blocks times the slices reach
// BLOCKS_PER_SM blocks per SM, but at most MAX_SLICES (a slice pays a fixed
// start, and the fold reads one partial per slice), each a whole number of
// mask tiles
int slice_width(int P, int N) {
  const int tpb = block_threads(P, PT);
  const int pod_blocks = cdiv(P, tpb * PT);
  const int want = BLOCKS_PER_SM * device_sms();
  const int slices = std::max(
      1, std::min({cdiv(want, pod_blocks), cdiv(N, TN), MAX_SLICES}));
  return round_up(cdiv(N, slices), TN);
}

struct LaunchArgs {
  const float *req, *req_nz;
  const uint8_t* active;
  const int32_t* pod_ids;
  const float *alloc, *used, *used_nz, *npods, *maxpods;
  const uint8_t* smask_t;
  int P, N, slice_w, S, node_offset;
  float* part_best;
  int32_t* part_idx;
  unsigned long long* rec;
};

template <int R, bool MURMUR>
cudaError_t launch_slices(const LaunchArgs& a, cudaStream_t st) {
  constexpr int K = pt_for(R);
  const int tpb = block_threads(a.P, K);
  const size_t smem =
      static_cast<size_t>(TNS) * node_floats(R) * sizeof(float) +
      static_cast<size_t>(STAGES) * TN * tpb * K;
  auto kern = claims_slice_kernel<R, K, MURMUR>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(cdiv(a.P, tpb * K), a.S);
  kern<<<grid, tpb, smem, st>>>(a.req, a.req_nz, a.active, a.pod_ids,
                                a.alloc, a.used, a.used_nz, a.npods,
                                a.maxpods, a.smask_t, a.P, a.N, a.slice_w,
                                a.node_offset, a.part_best, a.part_idx,
                                a.rec);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(const LaunchArgs& a, bool murmur, cudaStream_t st) {
  return murmur ? launch_slices<R, true>(a, st)
                : launch_slices<R, false>(a, st);
}

cudaError_t dispatch(const LaunchArgs& a, int R, bool murmur,
                     cudaStream_t st) {
  switch (R) {
#define CLAIMS_CASE(r) \
  case r:              \
    return launch_r<r>(a, murmur, st);
    CLAIMS_CASE(2) CLAIMS_CASE(3) CLAIMS_CASE(4) CLAIMS_CASE(5)
    CLAIMS_CASE(6) CLAIMS_CASE(7) CLAIMS_CASE(8) CLAIMS_CASE(9)
    CLAIMS_CASE(10) CLAIMS_CASE(11) CLAIMS_CASE(12) CLAIMS_CASE(13)
    CLAIMS_CASE(14) CLAIMS_CASE(15) CLAIMS_CASE(16)
#undef CLAIMS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Rows of the scratch buffers for P pods and N nodes on the current
// device: one per node slice, then three rows of part_best hold the
// slices' shared per-pod records (8 bytes a pod, 8-byte aligned).
int claims_num_slices(int P, int N) {
  return cdiv(N, slice_width(P, N)) + 3;
}

int claims_max_resources() { return R_MAX; }

// Launch both kernels on `stream`.  smask_t is [N, round_up(P, 16)] uint8;
// part_best/part_idx hold claims_num_slices(P, N) * P entries.  The nodes
// are one shard of a node axis that starts at node_offset: the murmur
// noise hashes node_offset + n, so a shard's noise equals the matching
// columns of the whole axis', while claims stay local indices.  The sin
// rule is keyed on local indices and takes node_offset 0 only.  Returns the
// cudaError_t of the launches (0 on success); nothing is synchronised here.
int claims_launch(const float* req, const float* req_nz,
                  const uint8_t* active, const int32_t* pod_ids,
                  const float* alloc, const float* used, const float* used_nz,
                  const float* npods, const float* maxpods,
                  const uint8_t* smask_t, int P, int N, int R, int murmur,
                  int node_offset, float* part_best, int32_t* part_idx,
                  int32_t* claims, float* best, void* stream) {
  if (P <= 0 || N <= 0 || R < 2 || R > R_MAX || node_offset < 0 ||
      (!murmur && node_offset != 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w = slice_width(P, N);
  const int S = cdiv(N, w);
  const size_t rec_at = (static_cast<size_t>(S) * P + 1) & ~size_t{1};
  auto* rec = reinterpret_cast<unsigned long long*>(part_best + rec_at);
  cudaError_t err = cudaMemsetAsync(rec, 0, sizeof(*rec) * P, st);
  if (err != cudaSuccess) return err;
  const LaunchArgs a{req,     req_nz,    active,   pod_ids, alloc,
                     used,    used_nz,   npods,    maxpods, smask_t,
                     P,       N,         w,        S,       node_offset,
                     part_best, part_idx, rec};
  err = dispatch(a, R, murmur != 0, st);
  if (err != cudaSuccess) return err;
  claims_fold_kernel<<<cdiv(P, FOLD_PODS), FOLD_PODS * FOLD_CHUNKS, 0, st>>>(
      part_best, part_idx, P, N, S, claims, best);
  return cudaGetLastError();
}

}  // extern "C"

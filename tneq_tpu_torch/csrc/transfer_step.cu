// Hand-written Hopper (sm_90a) kernels for the MPS transfer sweep of the
// Born-rule forward and of its d_env backward.
//
// Replaces the two Pallas kernels of tneq_tpu/ops/pallas_kernels.py:
//   B3  fused_transfer_step          (pl.pallas_call at pallas_kernels.py:91)
//   B4  fused_transfer_step_complex  (pl.pallas_call at pallas_kernels.py:177)
// JAX runs one kernel call per transfer step inside a lax.scan, forward and
// backward (the custom VJP, pallas_kernels.py:231-262, runs d_env through
// the same kernel on the transposed core).  Here one launch runs all the
// steps of a sweep: once forward, once for the backward's d_env chain.
// d_a and d_mx stay batched torch.einsum contractions over the stack of
// sites (ops/transfer_step.py), as JAX left them to XLA.
//
// One step, for env [B, Da, Da], A [Da, K, Dc], Mx [B, K, K]:
//     out[z,c,d] = sum_{a,b,k,l} env[z,a,b] * ket(A)[a,k,c] * bra(A)[b,l,d] * op(Mx)[z,k,l]
// Forward: ket = op = identity, bra = identity (B3) or conj (B4).  The sweep
// over a stack A [n, Da, K, Dc], Mx [n, B, K, K] writes every step's env:
//     out[0] = step(env0, A[0], Mx[0]),  out[i] = step(out[i-1], A[i], Mx[i]).
// Backward (the d_env chain): the sites in reverse, each core transposed
// (2,1,0) as it is staged, and for B4 ket = op = conj, bra = identity (the
// step on conj(A)^T and conj(Mx)); the result of site i is written to
// out[i], so out[i] is the cotangent of site i's input env.
//
// Design.  The TPU forms the [D^2 K^2, B] outer product E = env (x) Mx and
// runs ONE MXU matmul W[cd, abkl] @ E per 512-lane block (2 B D^4 K^2
// flops, at Precision.HIGHEST).  Here the step is factorised, 2 B (2 D^3 K +
// D^2 K^2) flops (13x fewer at D = 8, K = 4):
//     T1[z,b,k,c] = sum_a   env[z,a,b] ket(A)[a,k,c]
//     T2[z,b,l,c] = sum_k   T1[z,b,k,c] op(Mx)[z,k,l]
//     out[z,c,d]  = sum_b,l T2[z,b,l,c] bra(A)[b,l,d]
// Two routes, chosen by ops/transfer_step.kernel_plan from shape and dtype.
//
// Narrow route (transfer_sweep_kernel; the Born-rule widths, D < 32).  A
// step is microseconds of latency, not bytes or flops, and each batch
// entry's chain of sites is independent of every other's, so:
//   * Persistent blocks.  One block of 256 threads owns a group of zb batch
//     entries for the whole sweep; its env stays in shared memory from one
//     site to the next (two buffers: the column strips of site i write the
//     next env while later strips still read this one).  Each out[i] is
//     written to global memory once and never read back.
//   * Prefetch.  A[i] and the group's Mx[i] do not depend on the carry:
//     they are copied with cp.async into a ring of up to 8 stages, one
//     commit group per site, issued at the start for as many sites as the
//     ring holds (all of a born_rule sweep) and refilled as sites finish
//     (16-byte copies where aligned, element copies otherwise; the
//     backward's transposed core is gathered element by element).  A site's
//     chain then holds only shared-memory arithmetic and three block
//     barriers, not a trip to L2 or HBM.
//   * zb from the batch.  The plan spreads the batch over the card's 132
//     SMs, up to 32 entries per block, so one copy of A per block and site
//     serves many entries.
//   * Register tiles.  Each product phase gives a thread a tile x tile block
//     of outputs (tile 1, 2 or 4 from the plan): per summed index it loads
//     2*tile shared values for tile^2 FMAs.  Where one group's T1/T2 would
//     outgrow shared memory, a site walks over strips of ct columns c.
//     T1/T2 rows and entries have odd pitches against bank conflicts.
//   * Summation order: each output sums its index from 0 upwards in one
//     accumulator, as the plain version's loops do.  B4 uses native complex
//     FMAs on float2, not the TPU's stacked real form.
//
// Wide route (transfer_wide_kernel; D >= 32, and every core that does not
// fit the narrow route, up to D = 256, K = 64).  Phases 1 and 3 are
// matrix products that read the same core for every entry: T1 is M = zb D
// rows (z, b), N = K D columns (k, c), depth D; out is M = zb D rows (z,
// c), N = D, depth D K.  They and phase 2 run on the tensor cores:
//   * 3xTF32.  mma.sync m16n8k8 in TF32 with float32 accumulation; every
//     operand x is split as x = hi + lo (two TF32 values) and a product is
//     hi hi + hi lo + lo hi, which keeps float32 accuracy (the dropped lo lo
//     is below 2^-22 of it), as JAX's HIGHEST kept it on the MXU.  B4 takes
//     four real products per complex product (re = ar br - ai bi, im = ar bi
//     + ai br), never the three-product form, which loses digits.  The
//     tensor core truncates as it accumulates, which over a depth of D K
//     lost ~1e-5 (measured); so each 8-deep k-step is summed afresh and
//     added to the running float32 sum, round to nearest (~1e-6).
//   * Thread-block clusters.  A cluster of C CTAs (2-8, 16 with the
//     non-portable size) owns a group of zb entries for the whole sweep.
//     CTA j owns the strip of cs output columns c [j cs, (j+1) cs), which
//     is the strip of rows a of the next env: it keeps that part of the
//     group's env in its shared memory, double-buffered, and phase 1 of the
//     next site reads every row a from the CTA that holds it, through
//     distributed shared memory, after one cluster barrier per site.  With
//     the env split C ways no CTA holds a whole env: the width limit of the
//     narrow route (fault C3: a complex64 env of D = 120 and more, double-
//     buffered, outgrew one block) is gone.  The plan takes the narrowest
//     strips (of 8 columns and more) that at most 8 CTAs cover D with, and
//     zb so that a launch has 132 CTAs or more wherever B C allows.
//   * Streamed cores.  The core goes through a ring of 3-4 tiles in each
//     CTA's shared memory, issued stages - 2 tiles ahead across phases and
//     sites (the next site's first tiles are in flight while this site's
//     products run; its Mx rides with its first tile).  A phase-1 tile is
//     the CTA's own column strip: cp.async (16-byte copies, zero-filled at
//     ragged edges, where rows are 16-byte aligned; element copies
//     otherwise).  A phase-3 tile holds the same rows of the core in every
//     CTA of the cluster: each CTA fetches every C-th row with one TMA bulk
//     copy (cp.async.bulk) multicast to the whole cluster, completing on
//     the slot's mbarrier in every CTA, so the cluster reads each row from
//     L2 once.  A split cluster barrier per tile keeps a slot from being
//     refilled while any CTA still reads it.  The backward's transposed
//     core is staged in its stored order ([k][c][a] and [d][(l, b)]) and
//     read by fragments in that order: nothing is transposed in global
//     memory.
//   * Chunks.  Where T1 (K slabs of rows b, columns c) or T2 outgrow shared
//     memory, a site walks over chunks of bc rows b (phase 3 sums over
//     them in its accumulators), of lc slabs l, and of kg slabs k (then
//     phase 2 sums the k-groups into T2 and phase 1 reruns per l-chunk).
//   * Warps.  Phases 1 and 2 give each warp a contiguous run of output
//     tiles (16 x 8) and take them one at a time (phase 1 sums its a-tiles
//     into T1 in shared memory); phase 3 holds 1 or 4 tiles per warp across
//     the site (a template choice per launch) and splits its depth over
//     the warps where it has fewer tiles than warps, summing the parts in a
//     fixed order.  Pitches keep the fragment loads free of bank conflicts;
//     ragged edges in B, D, K and n are zero-filled or masked.  One loop
//     walks a site's tiles in the producer's order, so the producer's code
//     is inlined at one place.
//
// What bounds it on an H100.  At the born_rule width (B = 512, D = 8, K = 4,
// n = 5, f32) the sweep reads and writes ~1.4 MB and does 26 MFLOP: 0.4 us
// by operations; the launch and the n dependent sites are the cost.  At
// the wide widths a site is operations: (32, 64, 16) in complex64 is 2.4
// GFLOP, 36 us on the CUDA cores at 67 TFLOP/s and 15 us as 3xTF32 on the
// tensor cores at 495 TFLOP/s; the cores' bytes (512 KiB per site) are a
// few microseconds.  Measured (PERF.md), the wide route is far from either
// bound: per-CTA cycle counts put its time in latency -- short dependent
// chains of mma.sync per warp with 8 warps per SM, DSMEM reads of the env
// in phase 1, and a barrier per tile -- not in the tensor cores' rate.
// Later work: warp-specialised producer and consumers, wgmma on 64-row
// tiles, and fewer, larger tiles per site.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns
// cudaGetLastError() after its launch (0 = success); it launches on the
// caller's stream, does not synchronise and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxStages = 8;  // sites of A / Mx staged ahead

struct Real {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  // c + x * y
  static __device__ __forceinline__ T fma(T x, T y, T c) { return fmaf(x, y, c); }
  static __device__ __forceinline__ T conj(T x) { return x; }
};

struct Complex {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ T fma(T x, T y, T c) {
    c.x = fmaf(x.x, y.x, c.x);
    c.x = fmaf(-x.y, y.y, c.x);
    c.y = fmaf(x.x, y.y, c.y);
    c.y = fmaf(x.y, y.x, c.y);
    return c;
  }
  static __device__ __forceinline__ T conj(T x) { return make_float2(x.x, -x.y); }
};

// ket, op and bra of the step: forward (ket, op plain; bra conj) or the
// backward's d_env chain (ket, op conj; bra plain).  conj is the identity
// for Real.
template <class Ops, bool Backward>
struct Roles {
  using T = typename Ops::T;
  static __device__ __forceinline__ T ket(T x) { return Backward ? Ops::conj(x) : x; }
  static __device__ __forceinline__ T op(T x) { return Backward ? Ops::conj(x) : x; }
  static __device__ __forceinline__ T bra(T x) { return Backward ? x : Ops::conj(x); }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

template <class T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All threads of the cluster, with release/acquire.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (0 <= pending < kMaxStages - 1; anything else waits for all).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
#define TNEQ_WAIT(N)                                                  \
  case N:                                                             \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); \
    break;
    TNEQ_WAIT(1)
    TNEQ_WAIT(2)
    TNEQ_WAIT(3)
    TNEQ_WAIT(4)
    TNEQ_WAIT(5)
    TNEQ_WAIT(6)
#undef TNEQ_WAIT
    default:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// x / d and x % d for 0 <= x < 2^24 by a float reciprocal and one
// correction: a tile's index math on the chain of every site, without the
// ~20-instruction integer division.
struct FastDiv {
  int d;
  float inv;
  __device__ __forceinline__ explicit FastDiv(int d_) : d(d_), inv(1.0f / (float)d_) {}
  __device__ __forceinline__ int div(int x) const {
    int q = __float2int_rz((float)x * inv);
    const int r = x - q * d;
    q += (r >= d) - (r < 0);
    return q;
  }
  __device__ __forceinline__ int mod(int x) const { return x - div(x) * d; }
};

// Copy `count` contiguous elements to shared memory, spread over the block.
template <class T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int count) {
  const size_t bytes = (size_t)count * sizeof(T);
  if ((((uintptr_t)dst | (uintptr_t)src | bytes) & 15) == 0) {
    for (int i = threadIdx.x; i < (int)(bytes / 16); i += blockDim.x)
      cp_async16(reinterpret_cast<char*>(dst) + 16 * i,
                 reinterpret_cast<const char*>(src) + 16 * i);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) cp_async_elem(dst + i, src + i);
  }
}

// The backward's core, logical A[a,k,c] = stored A[c,k,a] (stored
// [Dc, K, Da]), gathered element by element into shared memory.  Kept out of
// line so its index math does not weigh on the registers of the product
// loops; it runs once per site.
template <class T>
__device__ __noinline__ void gather_transposed(T* dst, const T* src, int Da, int K, int Dc) {
  const FastDiv fDc(Dc), fK(K);
  for (int idx = threadIdx.x; idx < Da * K * Dc; idx += blockDim.x) {
    const int ak = fDc.div(idx);  // aa * K + k
    const int c = idx - ak * Dc;
    const int aa = fK.div(ak);
    const int k = ak - aa * K;
    cp_async_elem(dst + idx, src + ((size_t)c * K + k) * Da + aa);
  }
}

// P independent products C_p[m][n] = sum_q X_p[q*xq + m] * fy(Y_p[q*yq + n])
// for m < M, n < N, q < Q, spread over the block in Tile x Tile register
// tiles (n-tiles fastest).  bases(p, x, y) gives the product's operands;
// store(p, m, n, v) writes one result.  Rows and columns past the edge load
// the last valid element and are not stored.
template <class Ops, int Tile, class FY, class Bases, class Store>
__device__ __forceinline__ void tile_products(int P, int M, int N, int Q, int xq, int yq,
                                              Bases bases, FY fy, Store store) {
  using T = typename Ops::T;
  const FastDiv tm((M + Tile - 1) / Tile);
  const FastDiv tn((N + Tile - 1) / Tile);
  const int total = P * tm.d * tn.d;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int mp = tn.div(t);  // m-tile + tm * p
    const int n0 = (t - mp * tn.d) * Tile;
    const int p = tm.div(mp);
    const int m0 = (mp - p * tm.d) * Tile;
    const T* x;
    const T* y;
    bases(p, x, y);
    int mo[Tile], no[Tile];
#pragma unroll
    for (int r = 0; r < Tile; ++r) {
      mo[r] = min(m0 + r, M - 1);
      no[r] = min(n0 + r, N - 1);
    }
    T acc[Tile][Tile];
#pragma unroll
    for (int r = 0; r < Tile; ++r)
#pragma unroll
      for (int s = 0; s < Tile; ++s) acc[r][s] = Ops::zero();
#pragma unroll 4
    for (int q = 0; q < Q; ++q) {
      T xv[Tile], yv[Tile];
#pragma unroll
      for (int r = 0; r < Tile; ++r) xv[r] = x[q * xq + mo[r]];
#pragma unroll
      for (int s = 0; s < Tile; ++s) yv[s] = fy(y[q * yq + no[s]]);
#pragma unroll
      for (int r = 0; r < Tile; ++r)
#pragma unroll
        for (int s = 0; s < Tile; ++s) acc[r][s] = Ops::fma(xv[r], yv[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < Tile; ++r)
#pragma unroll
      for (int s = 0; s < Tile; ++s)
        if (m0 + r < M && n0 + s < N) store(p, m0 + r, n0 + s, acc[r][s]);
  }
}

// T1 and T2 hold one entry's [Da, K, ct] strip with an odd row pitch
// (ct | 1) and an odd pitch per entry, so the lanes of a warp that read
// rows of several b or entries fall in different banks.
__host__ __device__ inline int row_pitch(int ct) { return ct | 1; }
__host__ __device__ inline int entry_pitch(int Da, int K, int ct) {
  return (Da * K * row_pitch(ct)) | 1;
}

// Shared memory of one block, in elements (the plan in ops/transfer_step.py
// computes the same): `stages` copies of A and of the group's Mx, `envs` env
// buffers (2 when the sweep has more than one site), T1 and T2.
__host__ __device__ inline size_t smem_elems(int n, int Da, int K, int Dc, int zb, int ct,
                                             int stages) {
  const int envs = n > 1 ? 2 : 1;
  return (size_t)stages * ((size_t)Da * K * Dc + (size_t)zb * K * K) +
         (size_t)zb * ((size_t)envs * Da * Da + 2 * (size_t)entry_pitch(Da, K, ct));
}

// A and Mx pass through the cp.async ring of `stages` buffers.
template <class Ops, bool Backward, int Tile>
__global__ void __launch_bounds__(kThreads)
transfer_sweep_kernel(const typename Ops::T* __restrict__ env0,
                      const typename Ops::T* __restrict__ a,
                      const typename Ops::T* __restrict__ mx, int n, int B, int Da,
                      int K, int Dc, int zb, int ct, int stages,
                      typename Ops::T* __restrict__ out) {
  using T = typename Ops::T;
  using R = Roles<Ops, Backward>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DK = Da * K;
  const int DKC = DK * Dc;
  const int KK = K * K;
  const int DD = Da * Da;
  T* sA = reinterpret_cast<T*>(smem_raw);  // [stages][Da, K, Dc] (logical layout), a ring
  T* sMx = sA + stages * DKC;              // [stages][zb, K, K]
  T* sEnv = sMx + stages * zb * KK;        // [envs][zb, Da, Da]
  const int rp = row_pitch(ct);
  const int ep = entry_pitch(Da, K, ct);
  T* sT1 = sEnv + (n > 1 ? 2 : 1) * zb * DD;  // [zb][Da, K][ct], pitches rp, ep
  T* sT2 = sT1 + zb * ep;                     // [zb][Da, K][ct], pitches rp, ep

  const int z0 = blockIdx.x * zb;
  const int nz = min(zb, B - z0);
  const FastDiv fK(K), fDa(Da);

  // Stage site s (sweep order) into buffer st and commit it as one group.
  auto load_site = [&](int s, int st) {
    const int i = Backward ? n - 1 - s : s;
    if (Backward)
      gather_transposed(sA + st * DKC, a + (size_t)i * DKC, Da, K, Dc);
    else
      copy_async(sA + st * DKC, a + (size_t)i * DKC, DKC);
    copy_async(sMx + st * zb * KK, mx + ((size_t)i * B + z0) * KK, nz * KK);
    cp_async_commit();
  };

  // Prologue: env0 and the first `stages` sites, one group per site.
  copy_async(sEnv, env0 + (size_t)z0 * DD, nz * DD);
  for (int s = 0; s < min(n, stages); ++s) load_site(s, s);

  for (int s = 0; s < n; ++s) {
    const int i = Backward ? n - 1 - s : s;
    const int st = s % stages;
    // sites staged so far: the prologue's, one more per site since site 1
    const int issued = stages == 1 ? s + 1 : min(n, stages + max(s - 1, 0));
    cp_async_wait(issued - s - 1);
    __syncthreads();  // site s staged; every thread is done with site s-1
    if (stages > 1 && s > 0 && s + stages - 1 < n)
      load_site(s + stages - 1, (s - 1) % stages);  // into site s-1's buffer
    const T* A_ = sA + st * DKC;
    const T* M_ = sMx + st * zb * KK;
    const T* E_ = sEnv + (s & 1) * zb * DD;
    T* E_next = s + 1 < n ? sEnv + ((s + 1) & 1) * zb * DD : nullptr;
    T* out_i = out + ((size_t)i * B + z0) * Dc * Dc;

    for (int c0 = 0; c0 < Dc; c0 += ct) {
      const int w = min(ct, Dc - c0);
      // T1[zz,b,k,j] = sum_a env[zz,a,b] ket(A)[a,k,c0+j]; product (zz, k)
      tile_products<Ops, Tile>(
          nz * K, Da, w, Da, Da, K * Dc,
          [&](int p, const T*& x, const T*& y) {
            x = E_ + fK.div(p) * DD;
            y = A_ + fK.mod(p) * Dc + c0;
          },
          [](T v) { return R::ket(v); },
          [&](int p, int b, int j, T v) {
            const int zz = fK.div(p);
            sT1[zz * ep + (b * K + p - zz * K) * rp + j] = v;
          });
      __syncthreads();
      // T2[zz,b,l,j] = sum_k T1[zz,b,k,j] op(Mx)[zz,k,l]; product (zz, b)
      tile_products<Ops, Tile>(
          nz * Da, w, K, K, rp, K,
          [&](int p, const T*& x, const T*& y) {
            const int zz = fDa.div(p);
            x = sT1 + zz * ep + (p - zz * Da) * K * rp;
            y = M_ + zz * KK;
          },
          [](T v) { return R::op(v); },
          [&](int p, int j, int l, T v) {
            const int zz = fDa.div(p);
            sT2[zz * ep + ((p - zz * Da) * K + l) * rp + j] = v;
          });
      __syncthreads();
      // out[zz,c0+j,d] = sum_{b,l} T2[zz,b,l,j] bra(A)[b,l,d]; product zz
      tile_products<Ops, Tile>(
          nz, w, Dc, DK, rp, Dc,
          [&](int p, const T*& x, const T*& y) {
            x = sT2 + p * ep;
            y = A_;
          },
          [](T v) { return R::bra(v); },
          [&](int p, int j, int d, T v) {
            const int o = (p * Dc + c0 + j) * Dc + d;
            out_i[o] = v;
            if (E_next) E_next[o] = v;
          });
      // No barrier: the next strip's T1 overwrites what T2 read before the
      // barrier above, and its T2 waits behind its own T1 barrier.
    }
    if (stages == 1 && s + 1 < n) {
      __syncthreads();  // every thread is done with the one stage
      load_site(s + 1, 0);
    }
  }
}


// ---------------------------------------------------------------------------
// The wide route: one thread-block cluster per group of entries, products
// on the tensor cores in 3xTF32 (design note at the top of the file).
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kMaxWideCluster = 16;
constexpr int kPortableCluster = 8;
constexpr int kMaxRing = 4;
constexpr int kMaxWideD = 256;
constexpr int kMaxWideK = 64;
constexpr int kMaxWideZb = 8;

__host__ __device__ inline int cdiv(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ inline int round_up(int x, int m) { return cdiv(x, m) * m; }

// Row pitches (in elements) that keep a warp's fragment loads free of bank
// conflicts.  "tg": lane (g = lane / 4, t = lane % 4) reads element
// t * P + g (rows step with t); float needs P = 8 mod 16, float2 (read by
// half-warps) P = 4 mod 8.  "gt": lane reads g * P + t; P = 4 mod 8.  Both
// are multiples of 4 elements, so every row starts 16-byte aligned.
__host__ __device__ inline int pitch_tg(int x, bool cx) {
  int p = round_up(x, 4);
  while (cx ? p % 8 != 4 : p % 16 != 8) p += 4;
  return p;
}
__host__ __device__ inline int pitch_gt(int x) {
  int p = round_up(x, 4);
  while (p % 8 != 4) p += 4;
  return p;
}

// The launch plan of the wide route (ops/transfer_step.kernel_plan).
struct WidePlan {
  int n, B, Da, K, Dc;
  int zb;      // batch entries per cluster
  int cs;      // columns c of out (rows a of the next env) per CTA: a multiple of 8
  int C;       // CTAs per cluster: C * cs >= max(Da, Dc)
  int bc;      // rows b per chunk of T1/T2: a multiple of 16
  int kg;      // slabs k of T1 held at once
  int lc;      // slabs l of T2 held at once: a multiple of 8
  int ka;      // rows a per staged tile of the core's column strip: a multiple of 8
  int qt;      // rows b per staged tile of the core: a multiple of 8 dividing bc
  int lt;      // slabs l per staged tile of the core (> 1 only where qt = bc)
  int stages;  // tiles in the ring
};

// Phase-3 output tiles (16 x 8) a warp may hold: a CTA has at most 32.
constexpr int kMaxTiles3 = 4;

// Shapes and shared-memory regions (in elements) derived from a plan; the
// Python plan computes the same.
struct WideLayout {
  int K8, Da8, Dc16, nbc, nkg, nlc, na, lcs;
  int Pe, PK, Pc, SK1, P1, P3;  // pitches
  int N1, N2, N3, split, m_last;
  size_t bar_el, env_el, mx_el, t1_el, t2_el, sb_el, total_el;
};

__host__ __device__ inline WideLayout wide_layout(const WidePlan& p, bool cx, bool bwd) {
  WideLayout L;
  L.K8 = round_up(p.K, 8);
  L.Da8 = round_up(p.Da, 8);
  L.Dc16 = round_up(p.Dc, 16);
  L.nbc = cdiv(p.Da, p.bc);
  L.nkg = cdiv(p.K, p.kg);
  L.nlc = cdiv(p.K, p.lc);
  L.na = cdiv(p.Da, p.ka);
  L.lcs = p.lc < p.K ? p.lc : p.K;
  L.Pe = pitch_tg(L.nbc * p.bc, cx);  // env rows a, columns b
  L.PK = pitch_tg(L.nlc * p.lc, cx);  // Mx rows k, columns l
  L.Pc = pitch_tg(p.cs, cx);          // T1/T2 rows b, columns c
  L.SK1 = pitch_tg(p.bc * L.Pc, cx);  // one slab k (T1) or l (T2)
  // the core's tiles: phase 1 [kg][ka][cs] (forward) or [kg][cs][ka]
  // (backward); phase 3 [lt][qt][d] (forward) or [d][lt][qt] (backward)
  L.P1 = bwd ? pitch_gt(p.ka) : L.Pc;
  L.P3 = bwd ? pitch_gt(p.lt * p.qt) : pitch_tg(L.Dc16, cx);
  const size_t t1_tile = (size_t)p.kg * (bwd ? (size_t)p.cs * L.P1 : (size_t)p.ka * L.P1);
  const size_t t3_tile = bwd ? (size_t)L.Dc16 * L.P3 : (size_t)p.lt * p.qt * L.P3;
  L.N1 = p.zb * (p.bc / 16) * p.kg * (p.cs / 8);
  L.N2 = p.zb * (p.bc * p.cs / 16) * (p.lc / 8);
  L.N3 = (L.Dc16 / 16) * p.zb * (p.cs / 8);
  L.split = 1;
  while (L.N3 * L.split * 2 <= kWarps) L.split *= 2;
  // phase-3 tiles after the last phase 2 of a site
  const int last_rows = L.Da8 - (L.nbc - 1) * p.bc;
  L.m_last = cdiv(p.K - (L.nlc - 1) * p.lc, p.lt) *
             cdiv(last_rows < p.bc ? last_rows : p.bc, p.qt);
  const size_t scratch = (size_t)(L.split - 1) * L.N3 * 32 * 4;  // elements: 4 per lane and tile
  const int envs = p.n > 1 ? 2 : 1;
  auto r4 = [](size_t x) { return (x + 3) / 4 * 4; };
  L.env_el = r4((size_t)envs * p.zb * p.cs * L.Pe);
  L.mx_el = r4((size_t)p.zb * L.K8 * L.PK);
  const size_t t1 = (size_t)p.zb * p.kg * L.SK1;
  L.t1_el = r4(t1 > scratch ? t1 : scratch);
  L.t2_el = r4((size_t)p.zb * L.lcs * L.SK1);
  L.sb_el = r4(t1_tile > t3_tile ? t1_tile : t3_tile);
  L.bar_el = kMaxRing * sizeof(uint64_t) / (cx ? 8 : 4);  // one mbarrier per ring slot
  L.total_el =
      L.bar_el + L.env_el + L.mx_el + L.t1_el + L.t2_el + (size_t)p.stages * L.sb_el;
  return L;
}

// The plan's values, checked against what the kernel assumes.
inline bool wide_ok(const WidePlan& p, const WideLayout& L, bool cx, size_t smem,
                    size_t elem) {
  const int D = p.Da > p.Dc ? p.Da : p.Dc;
  return p.n >= 1 && p.B >= 1 && p.Da >= 1 && p.Dc >= 1 && D <= kMaxWideD && p.K >= 1 &&
         p.K <= kMaxWideK && (p.n == 1 || p.Da == p.Dc) && p.zb >= 1 &&
         p.zb <= kMaxWideZb && cdiv(p.B, p.zb) <= 65535 && p.cs >= 8 && p.cs % 8 == 0 &&
         p.C >= 1 && p.C <= kMaxWideCluster && p.C * p.cs >= D && (p.C - 1) * p.cs < D &&
         p.bc >= 16 && p.bc % 16 == 0 && p.kg >= 1 && p.kg <= p.K && p.lc >= 8 &&
         p.lc % 8 == 0 && p.ka >= 8 && p.ka % 8 == 0 && p.qt >= 8 && p.qt % 8 == 0 &&
         p.bc % p.qt == 0 && p.lt >= 1 && p.lt <= p.lc && (p.lt == 1 || p.qt == p.bc) &&
         p.stages >= 3 && p.stages <= kMaxRing && L.N3 <= kMaxTiles3 * kWarps &&
         p.stages - 2 <= L.m_last &&
         elem * L.total_el <= smem && smem <= kMaxSmem;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo as two TF32 values (lo = 0 where x is not finite: hi carries
// the infinity or NaN).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  const float r = x - __uint_as_float(hi);
  lo = to_tf32(isfinite(x) ? r : 0.f);
}

// d += a * b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), d 16 x 8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: a * b = a_hi b_hi + a_hi b_lo + a_lo b_hi (+ a_lo b_lo, dropped),
// the small products first.  `neg` flips the sign of a.  The tensor core
// adds into its accumulator with truncation, which over a long depth loses
// about one unit in the last place per product: so each k-step's product
// is formed in a fresh accumulator and added to the running sum by the
// caller in float32 (round to nearest).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1, bool neg = false) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = neg ? ah[j] ^ 0x80000000u : ah[j];
    l[j] = neg ? al[j] ^ 0x80000000u : al[j];
  }
  mma_tf32(d, l, bh0, bh1);
  mma_tf32(d, h, bl0, bl1);
  mma_tf32(d, h, bh0, bh1);
}

// Fragments and accumulators of the wide route.  An A fragment holds the
// lane's four values of a 16 x 8 tile ((g, t), (g+8, t), (g, t+4),
// (g+8, t+4)), a B fragment its two of an 8 x 8 tile ((t, g), (t+4, g)),
// an accumulator its four outputs ((g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)).  Each value is split into TF32 hi and lo parts as loaded.
struct WReal {
  using T = float;
  static constexpr bool kComplex = false;
  struct A { uint32_t h[4], l[4]; };
  struct Bf { uint32_t h[2], l[2]; };
  struct Acc { float v[4]; };
  static __device__ __forceinline__ T conj(T x) { return x; }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void set(A& f, int j, T x) { split_tf32(x, f.h[j], f.l[j]); }
  static __device__ __forceinline__ void set(Bf& f, int j, T x) { split_tf32(x, f.h[j], f.l[j]); }
  static __device__ __forceinline__ void clear(Acc& c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c.v[j] = 0.f;
  }
  static __device__ __forceinline__ void mma(Acc& c, const A& a, const Bf& b) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(d, a.h, a.l, b.h[0], b.h[1], b.l[0], b.l[1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) c.v[j] += d[j];
  }
  static __device__ __forceinline__ T get(const Acc& c, int j) { return c.v[j]; }
  static __device__ __forceinline__ void put(Acc& c, int j, T x) { c.v[j] = x; }
  static __device__ __forceinline__ T add(T x, T y) { return x + y; }
};

// Complex: four real products per complex product, each in 3xTF32:
// re += ar br - ai bi, im += ar bi + ai br.
struct WComplex {
  using T = float2;
  static constexpr bool kComplex = true;
  struct A { uint32_t rh[4], rl[4], ih[4], il[4]; };
  struct Bf { uint32_t rh[2], rl[2], ih[2], il[2]; };
  struct Acc { float re[4], im[4]; };
  static __device__ __forceinline__ T conj(T x) { return make_float2(x.x, -x.y); }
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void set(A& f, int j, T x) {
    split_tf32(x.x, f.rh[j], f.rl[j]);
    split_tf32(x.y, f.ih[j], f.il[j]);
  }
  static __device__ __forceinline__ void set(Bf& f, int j, T x) {
    split_tf32(x.x, f.rh[j], f.rl[j]);
    split_tf32(x.y, f.ih[j], f.il[j]);
  }
  static __device__ __forceinline__ void clear(Acc& c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c.re[j] = c.im[j] = 0.f;
  }
  static __device__ __forceinline__ void mma(Acc& c, const A& a, const Bf& b) {
    float re[4] = {0.f, 0.f, 0.f, 0.f}, im[4] = {0.f, 0.f, 0.f, 0.f};
    mma3(re, a.rh, a.rl, b.rh[0], b.rh[1], b.rl[0], b.rl[1]);
    mma3(re, a.ih, a.il, b.ih[0], b.ih[1], b.il[0], b.il[1], true);
    mma3(im, a.rh, a.rl, b.ih[0], b.ih[1], b.il[0], b.il[1]);
    mma3(im, a.ih, a.il, b.rh[0], b.rh[1], b.rl[0], b.rl[1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c.re[j] += re[j];
      c.im[j] += im[j];
    }
  }
  static __device__ __forceinline__ T get(const Acc& c, int j) {
    return make_float2(c.re[j], c.im[j]);
  }
  static __device__ __forceinline__ void put(Acc& c, int j, T x) {
    c.re[j] = x.x;
    c.im[j] = x.y;
  }
  static __device__ __forceinline__ T add(T x, T y) { return make_float2(x.x + y.x, x.y + y.y); }
};

// The A fragment at p: rows g and g + 8 at o0 and o8, column j at j * cst.
template <class W, bool Conj>
__device__ __forceinline__ void load_a(typename W::A& f, const typename W::T* p, int o0, int o8,
                                       int cst, int t) {
  const typename W::T x[4] = {p[o0 + t * cst], p[o8 + t * cst], p[o0 + (t + 4) * cst],
                              p[o8 + (t + 4) * cst]};
#pragma unroll
  for (int j = 0; j < 4; ++j) W::set(f, j, Conj ? W::conj(x[j]) : x[j]);
}

// The B fragment at p: column n at on, row k at k * kst.
template <class W, bool Conj>
__device__ __forceinline__ void load_b(typename W::Bf& f, const typename W::T* p, int on,
                                       int kst, int t) {
  const typename W::T y0 = p[on + t * kst], y1 = p[on + (t + 4) * kst];
  W::set(f, 0, Conj ? W::conj(y0) : y0);
  W::set(f, 1, Conj ? W::conj(y1) : y1);
}

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// The one local arrival of a phase, expecting `bytes` from bulk copies (0: none).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete; makes the bytes that
// completed it visible to this thread.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global memory to the same offset of the
// shared memory of every CTA in `mask`, completing them on the mbarrier at
// the same offset there (TMA).
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, unsigned bytes,
                                               uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` (< kMaxRing) of this thread's groups are in flight.
__device__ __forceinline__ void ring_wait(int pending) {
  switch (pending) {
    case 0: cp_async_wait_n<0>(); break;
    case 1: cp_async_wait_n<1>(); break;
    default: cp_async_wait_n<2>(); break;
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// One copy into shared memory: rows r = r1 * rdiv + r2 (r < R) of `width`
// elements.  A row is src + r1 * s1 + r2 * s2 in global memory, of which the
// first `vcount` elements are copied where r1 < lim1 and r2 < lim2 (none
// elsewhere), zeros after; it lands at dst + r1 * d1 + r2 * d2.  vec:
// 16-byte copies, zero-filled past the valid elements (every row 16-byte
// aligned at both ends); otherwise element copies.
struct Copy {
  const void* src;
  long long s1, s2;
  int R, rdiv, width, lim1, lim2, vcount, d1, d2;
  bool vec;
};

template <class T>
__device__ __forceinline__ void stage(T* __restrict__ dst, const Copy c) {
  const T* __restrict__ src = static_cast<const T*>(c.src);
  const long long s1 = c.s1, s2 = c.s2;
  const int rdiv = c.rdiv, lim1 = c.lim1, lim2 = c.lim2, vcount = c.vcount, d1 = c.d1,
            d2 = c.d2;
  const bool vec = c.vec;
  const FastDiv fr(rdiv);
  const int V = vec ? 16 / (int)sizeof(T) : 1;
  const FastDiv fw(cdiv(c.width, V));
  const int total = c.R * fw.d;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int r = fw.div(idx), e0 = (idx - r * fw.d) * V;
    const int r1 = fr.div(r), r2 = r - r1 * rdiv;
    const int valid = (r1 < lim1 && r2 < lim2) ? vcount : 0;
    const int cnt = min(max(valid - e0, 0), V);
    T* d = dst + r1 * d1 + r2 * d2 + e0;
    const T* s = src + r1 * s1 + r2 * s2 + e0;
    if (vec) {
      if (cnt > 0)
        cp_async16_zfill(d, s, cnt * (int)sizeof(T));
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (cnt > 0) {
      cp_async_elem(d, s);
    } else {
      *d = T{};
    }
  }
}

// Zeros in rows r < R of `width` elements at dst + (r / rdiv) * d1 + (r %
// rdiv) * d2 where skip(r / rdiv, r % rdiv) is false (16-byte stores).
template <class T, class Skip>
__device__ __forceinline__ void zero_rows(T* dst, int R, int rdiv, int width, int d1, int d2,
                                          Skip skip) {
  constexpr int V = 16 / sizeof(T);
  const FastDiv fr(rdiv), fw(cdiv(width, V));
  for (int idx = threadIdx.x; idx < R * fw.d; idx += kThreads) {
    const int r = fw.div(idx), e0 = (idx - r * fw.d) * V;
    const int r1 = fr.div(r), r2 = r - r1 * rdiv;
    if (!skip(r1, r2))
      *reinterpret_cast<float4*>(dst + r1 * d1 + r2 * d2 + e0) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The producer of the wide route: the tiles of the sweep in the order they
// are consumed -- per site, per chunk ib of rows b, per chunk il of slabs
// l: the phase-1 tiles (every k-group ikg, every a-tile ia; only at il = 0
// where T1 holds all K slabs), then the phase-3 tiles (lt slabs from l, qt
// rows b from iq qt of the chunk).  The first tile of a site brings the
// site's Mx, the first of the sweep env0.  A phase-1 tile (this CTA's
// column strip), env0 and Mx are this CTA's cp.async copies; a phase-3
// tile is the same rows of the core in every CTA of the cluster, so where
// its rows are 16-byte aligned (mcast) each CTA fetches every C-th row
// with one TMA bulk copy multicast to the whole cluster, which completes
// its bytes on the slot's mbarrier in every CTA; rows past the edge are
// zeroed by each CTA itself.
template <class T>
struct Producer {
  const T* env0;
  const T* a;
  const T* mx;
  T* sEnv;
  T* sMx;
  T* sRing;
  uint64_t* bars;  // one mbarrier per ring slot
  int z0, nz, c0, rank, C;
  bool vE, vM, vA, mcast, backward;
  int s, ib, il, ikg, ia, l, iq, issued;
  bool p1;
};

template <class T>
__device__ __forceinline__ void issue_tile(Producer<T>& pr, const WidePlan& p,
                                           const WideLayout& L) {
  const int n = p.n, K = p.K, Da = p.Da, Dc = p.Dc, cs = p.cs;
  if (pr.s < n) {
    T* dst = pr.sRing + (size_t)(pr.issued % p.stages) * L.sb_el;
    uint64_t* bar = pr.bars + pr.issued % p.stages;
    unsigned tx = 0;  // bytes the slot's mbarrier expects from bulk copies
    const int i = pr.backward ? n - 1 - pr.s : pr.s;
    const T* ai = pr.a + (size_t)i * Da * K * Dc;
    if (pr.p1 && pr.ib == 0 && pr.il == 0 && pr.ikg == 0 && pr.ia == 0) {
      if (pr.s == 0)  // env0: rows a of this CTA's strip, columns b
        stage(pr.sEnv, Copy{pr.env0 + ((size_t)pr.z0 * Da + pr.c0) * Da, (long long)Da * Da,
                            Da, p.zb * cs, cs, L.Pe, pr.nz, Da - pr.c0, Da, cs * L.Pe, L.Pe,
                            pr.vE});
      stage(pr.sMx, Copy{pr.mx + ((size_t)i * p.B + pr.z0) * K * K, (long long)K * K, K,
                         p.zb * L.K8, L.K8, L.PK, pr.nz, K, K, L.K8 * L.PK, L.PK, pr.vM});
    }
    if (pr.p1) {
      const int k0 = pr.ikg * p.kg, a0 = pr.ia * p.ka;
      if (pr.backward)  // [kg][cs][ka]: logical A[a,k,c] = stored[c,k,a]
        stage(dst, Copy{ai + ((size_t)pr.c0 * K + k0) * Da + a0, Da, (long long)K * Da,
                        p.kg * cs, cs, p.ka, K - k0, Dc - pr.c0, min(p.ka, Da - a0),
                        cs * L.P1, L.P1, pr.vA});
      else  // [kg][ka][cs]
        stage(dst, Copy{ai + ((size_t)a0 * K + k0) * Dc + pr.c0, Dc, (long long)K * Dc,
                        p.kg * p.ka, p.ka, cs, K - k0, Da - a0, max(0, min(cs, Dc - pr.c0)),
                        p.ka * L.P1, L.P1, pr.vA});
    } else {
      const int l0 = pr.il * p.lc + pr.l, bq = pr.ib * p.bc + pr.iq * p.qt;
      const int lcnt = min(p.lt, min(p.lc, K - pr.il * p.lc) - pr.l);
      const int vb = max(0, min(p.qt, Da - bq));  // rows b of the tile within the core
      const uint16_t mask = (uint16_t)((1u << pr.C) - 1);
      const int tid = threadIdx.x;
      if (pr.backward) {  // [d][lt][qt]: bra(A)[b,l,d] = stored[d,l,b]
        if (pr.mcast && vb == p.qt) {
          const unsigned seg = p.qt * sizeof(T);
          tx = Dc * lcnt * seg;
          zero_rows(dst, Dc * p.lt, p.lt, p.qt, L.P3, p.qt,
                    [=](int, int li) { return li < lcnt; });
          for (int v = pr.rank + pr.C * tid; v < Dc * lcnt; v += pr.C * kThreads) {
            const int d = v / lcnt, li = v - d * lcnt;
            bulk_multicast(dst + d * L.P3 + li * p.qt, ai + ((size_t)d * K + l0 + li) * Da + bq,
                           seg, bar, mask);
          }
        } else {
          stage(dst, Copy{ai + (size_t)l0 * Da + bq, (long long)K * Da, Da, Dc * p.lt, p.lt,
                          p.qt, Dc, lcnt, vb, L.P3, p.qt, pr.vA});
        }
      } else {  // [lt][qt][d]
        if (pr.mcast) {
          const unsigned row = Dc * sizeof(T);
          tx = lcnt * vb * row;
          zero_rows(dst, p.lt * p.qt, p.qt, Dc, p.qt * L.P3, L.P3,
                    [=](int li, int b) { return li < lcnt && b < vb; });
          for (int v = pr.rank + pr.C * tid; v < lcnt * vb; v += pr.C * kThreads) {
            const int li = v / vb, b = v - li * vb;
            bulk_multicast(dst + (li * p.qt + b) * L.P3,
                           ai + ((size_t)(bq + b) * K + l0 + li) * Dc, row, bar, mask);
          }
        } else {
          stage(dst, Copy{ai + ((size_t)bq * K + l0) * Dc, Dc, (long long)K * Dc,
                          p.lt * p.qt, p.qt, Dc, lcnt, Da - bq, Dc, p.qt * L.P3, L.P3,
                          pr.vA});
        }
      }
    }
    if (threadIdx.x == 0) mbar_arrive(bar, tx);
    // advance the cursor
    if (pr.p1) {
      if (++pr.ia == L.na) {
        pr.ia = 0;
        if (++pr.ikg == L.nkg) {
          pr.ikg = 0;
          pr.p1 = false;
        }
      }
    } else if (++pr.iq == cdiv(min(p.bc, L.Da8 - pr.ib * p.bc), p.qt)) {
      pr.iq = 0;
      if ((pr.l += p.lt) >= min(p.lc, K - pr.il * p.lc)) {
        pr.l = 0;
        if (++pr.il < L.nlc) {
          pr.p1 = L.nkg > 1;
        } else {
          pr.il = 0;
          pr.p1 = true;
          if (++pr.ib == L.nbc) {
            pr.ib = 0;
            ++pr.s;
          }
        }
      }
    }
  }
  cp_async_commit();
  ++pr.issued;
}

// MT3: the phase-3 output tiles a warp holds, 1 or 4 (the plan's N3 <= 8 or
// <= 32).
template <class W, bool Backward, int MT3>
__global__ void __launch_bounds__(kThreads, 1)
transfer_wide_kernel(const typename W::T* __restrict__ env0,
                     const typename W::T* __restrict__ a,
                     const typename W::T* __restrict__ mx, const WidePlan p,
                     typename W::T* __restrict__ out) {
  using T = typename W::T;
  using Acc = typename W::Acc;
  using R = Roles<W, Backward>;
  constexpr int MT = MT3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const WideLayout L = wide_layout(p, W::kComplex, Backward);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // [kMaxRing]: one per ring slot
  T* sEnv = reinterpret_cast<T*>(smem_raw) + L.bar_el;  // [envs][zb][cs][Pe]: rows a of the strip
  T* sMx = sEnv + L.env_el;                   // [zb][K8][PK]
  T* sT1 = sMx + L.mx_el;                     // [zb][kg][SK1]: slab k, rows b, columns c
  T* sT2 = sT1 + L.t1_el;                     // [zb][lcs][SK1]: slab l, rows b, columns c
  T* sRing = sT2 + L.t2_el;                   // [stages][sb]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n = p.n, B = p.B, Da = p.Da, K = p.K, Dc = p.Dc, zb = p.zb, cs = p.cs;
  const int bc = p.bc, kg = p.kg, lc = p.lc, ka = p.ka, qt = p.qt, lt = p.lt;
  const int stages = p.stages;
  const int z0 = blockIdx.y * zb, nz = min(zb, B - z0);
  const int c0 = rank * cs;  // this CTA's columns c of out, rows a of the env
  const int EE = cs * L.Pe, EM = L.K8 * L.PK, ES1 = kg * L.SK1, ES2 = L.lcs * L.SK1;
  const int NC = cs / 8, NN = zb * NC;

  const bool vA = aligned16(a) && ((Backward ? Da : Dc) * sizeof(T)) % 16 == 0;
  Producer<T> pr = {env0, a, mx, sEnv, sMx, sRing, bars, z0, nz, c0, rank, p.C,
                    aligned16(env0) && (Da * sizeof(T)) % 16 == 0,
                    aligned16(mx) && (K * sizeof(T)) % 16 == 0, vA, vA && p.C > 1, Backward,
                    0, 0, 0, 0, 0, 0, 0, 0, true};

  // ---- prologue: the slots' mbarriers set up in every CTA, the second env
  // buffer zeroed (its padding stays zero), the first stages - 2 tiles in
  // flight, env0 in place in every CTA
  if (tid == 0) {
    for (int k = 0; k < stages; ++k) mbar_init(&bars[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n > 1)
    for (int x = tid; x < zb * EE; x += kThreads) sEnv[zb * EE + x] = W::zero();
  cluster_sync();
  for (int k = 0; k < stages - 2; ++k) issue_tile(pr, p, L);
  ring_wait(stages - 3);
  cluster_sync();
  // Tile t lands in slot t % stages.  Consuming it, every CTA signals (a
  // split cluster barrier) that it is done with tile t - 1, and issues tile
  // t + stages - 2 into the slot of t - 2 once every CTA has signalled that
  // it is done with t - 2: no multicast lands in a slot a CTA still reads.
  int consumed = 0;
  bool arrived = false;
  auto next_tile = [&]() -> const T* {
    const int slot = consumed % stages;
    ring_wait(stages - 3);                               // this thread's copies of the tile
    mbar_wait(&bars[slot], (consumed / stages) & 1);     // its multicast rows
    __syncthreads();  // the tile is in place; every warp is done with the last one
    if (arrived) cluster_wait();
    issue_tile(pr, p, L);
    cluster_arrive();
    arrived = true;
    ++consumed;
    return sRing + (size_t)slot * L.sb_el;
  };

  // phase 3's split of the depth over warps where it has fewer tiles than warps
  const int split = L.split;
  const int tpw3 = split > 1 ? 1 : cdiv(L.N3, kWarps);
  const int first3 = split > 1 ? warp % L.N3 : warp * tpw3;
  const int slice = split > 1 ? warp / L.N3 : 0;  // active while < split
  const int n3 = slice < split ? max(0, min(tpw3, L.N3 - first3)) : 0;  // this warp's tiles
  const int tpw1 = cdiv(L.N1, kWarps), first1 = warp * tpw1;
  const int n1 = max(0, min(tpw1, L.N1 - first1));
  const int tpw2 = cdiv(L.N2, kWarps), first2 = warp * tpw2;
  const int n2 = max(0, min(tpw2, L.N2 - first2));
  const int MB = bc / 16, MR = bc * cs / 16, NL = lc / 8;
  auto roff = [&](int r) { return (r / cs) * L.Pc + r % cs; };  // row (b, c) of T1/T2

  // phase 3's tiles of this warp: its rows d of the staged core and its
  // columns (e, c) of T2, the same at every site
  int ao[MT], bo[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int idx = first3 + min(j, max(n3 - 1, 0));
    const int md = idx / NN, nn = idx - md * NN, e = nn / NC, cb = nn - e * NC;
    ao[j] = Backward ? (md * 16 + g) * L.P3 : md * 16 + g;
    bo[j] = e * ES2 + cb * 8 + g;
  }

  for (int s = 0; s < n; ++s) {
    const int i = Backward ? n - 1 - s : s;
    const T* env_cur = sEnv + (s & 1) * zb * EE;
    T* env_next = s + 1 < n ? sEnv + ((s + 1) & 1) * zb * EE : nullptr;
    Acc acc3[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) W::clear(acc3[j]);
    int kr = 0;  // phase-3 k-steps of this site so far, modulo split

    // ---- phase 1, one staged a-tile: T1[e,k,b,c] (+)= sum_a env[e,a,b]
    // ket(A)[a,k,c0+c] over its rows a, for the slabs k of group ikg and the
    // rows b from b0.  Tiles (e, 16 rows b, slab k, 8 columns c), one at a
    // time; env read from the CTA that holds each row a.
    auto phase1 = [&](const T* tile, int b0, int ia) {
      const int a0 = ia * ka, ksteps = min(ka, L.Da8 - a0) / 8;
      for (int idx = first1; idx < first1 + n1; ++idx) {
        const int nc = idx % NC, kl = (idx / NC) % kg, em = idx / (NC * kg);
        const int e = em / MB, mb = em - e * MB;
        const int ao1 = e * EE + b0 + mb * 16 + g;
        const int bo1 = Backward ? kl * cs * L.P1 + (nc * 8 + g) * L.P1
                                 : kl * ka * L.P1 + nc * 8 + g;
        int owner = a0 / cs, al = a0 - owner * cs;  // the CTA holding row a
        Acc acc;
        W::clear(acc);
#pragma unroll 2
        for (int kk = 0; kk < ksteps; ++kk) {
          const T* E = cluster.map_shared_rank(env_cur, owner) + al * L.Pe;
          if ((al += 8) == cs) {
            al = 0;
            ++owner;
          }
          typename W::A fa;
          load_a<W, false>(fa, E, ao1, ao1 + 8, L.Pe, t);
          typename W::Bf fb;
          load_b<W, Backward && W::kComplex>(fb, tile + (Backward ? kk * 8 : kk * 8 * L.P1),
                                             bo1, Backward ? 1 : L.P1, t);
          W::mma(acc, fa, fb);
        }
        T* o = sT1 + e * ES1 + kl * L.SK1 + (mb * 16 + g) * L.Pc + nc * 8 + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          T* oq = o + (q >> 1) * 8 * L.Pc + (q & 1);
          *oq = ia > 0 ? W::add(*oq, W::get(acc, q)) : W::get(acc, q);
        }
      }
    };

    // ---- phase 2: T2[e,l,b,c] (+)= sum_k T1[e,k,b,c] op(Mx)[e,k,l] for the
    // slabs l from l0 and the k of group ikg.  Tiles (e, 16 rows (b, c), 8
    // slabs l), one at a time; depth k, read as 0 past the group.
    auto phase2 = [&](int l0, int ikg) {
      const int k0 = ikg * kg, kv = min(kg, K - k0);
      for (int idx = first2; idx < first2 + n2; ++idx) {
        const int nl = idx % NL, em = idx / NL, e = em / MR, mr = em - e * MR;
        const int r0 = roff(mr * 16 + g), r8 = roff(mr * 16 + g + 8);
        const T* M = sMx + e * EM + k0 * L.PK + l0 + nl * 8 + g;
        Acc acc;
        W::clear(acc);
#pragma unroll 2
        for (int kk = 0; kk * 8 < kv; ++kk) {
          const int kr0 = kv - kk * 8;  // columns of this k-step within the group
          const bool v0 = t < kr0, v4 = t + 4 < kr0;
          const T* P = sT1 + e * ES1 + kk * 8 * L.SK1;
          const T x[4] = {v0 ? P[r0 + t * L.SK1] : W::zero(), v0 ? P[r8 + t * L.SK1] : W::zero(),
                          v4 ? P[r0 + (t + 4) * L.SK1] : W::zero(),
                          v4 ? P[r8 + (t + 4) * L.SK1] : W::zero()};
          typename W::A fa;
#pragma unroll
          for (int q = 0; q < 4; ++q) W::set(fa, q, x[q]);
          typename W::Bf fb;
          W::set(fb, 0, v0 ? R::op(M[(kk * 8 + t) * L.PK]) : W::zero());
          W::set(fb, 1, v4 ? R::op(M[(kk * 8 + t + 4) * L.PK]) : W::zero());
          W::mma(acc, fa, fb);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ll = nl * 8 + 2 * t + (q & 1);
          if (ll < L.lcs) {
            T* o = sT2 + e * ES2 + ll * L.SK1 + (q >> 1 ? r8 : r0);
            *o = ikg > 0 ? W::add(*o, W::get(acc, q)) : W::get(acc, q);
          }
        }
      }
    };

    // ---- phase 3, one staged tile: out^T[d,(e,c)] += sum_(l,b) bra(A)[b,l,d]
    // T2[e,l,b,c] over its lcnt slabs from ll and its rows b from bl0 of the
    // chunk at b0.  Tiles (16 rows d, 8 columns (e, c)) held across the site.
    auto phase3 = [&](const T* tile, int b0, int ll, int bl0, int lcnt) {
      const int kb = min(qt, L.Da8 - b0 - bl0) / 8;  // k-steps per slab
      for (int li = 0; li < lcnt; ++li) {
        for (int kk = 0; kk < kb; ++kk) {
          const bool mine = kr == slice;
          if (++kr == split) kr = 0;
          if (!mine) continue;
          const int q = li * qt + kk * 8;  // the k-step's first row of the tile
          const T* At = tile + (Backward ? q : q * L.P3);
          const T* Bt = sT2 + (ll + li) * L.SK1 + (bl0 + kk * 8) * L.Pc;
          typename W::A fa;
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            if (j < n3) {
              if (j == 0 || ao[j] != ao[j - 1])
                load_a<W, W::kComplex && !Backward>(fa, At, ao[j],
                                                   ao[j] + (Backward ? 8 * L.P3 : 8),
                                                   Backward ? 1 : L.P3, t);
              typename W::Bf fb;
              load_b<W, false>(fb, Bt, bo[j], L.Pc, t);
              W::mma(acc3[j], fa, fb);
            }
          }
        }
      }
    };

    // The site's tiles in the producer's order, from one call site: per
    // chunk ib of rows b, per chunk il of slabs l, the phase-1 tiles of each
    // k-group (then phase 2), then the phase-3 tiles.
    int ib = 0, il = 0, ikg = 0, ia = 0, ll = 0, iq = 0;
    bool p1 = true;
    for (;;) {
      const T* tile = next_tile();
      const int b0 = ib * bc, l0 = il * lc;
      if (p1) {
        phase1(tile, b0, ia);
        if (++ia == L.na) {
          ia = 0;
          __syncthreads();  // T1 complete
          phase2(l0, ikg);
          if (++ikg == L.nkg) {
            ikg = 0;
            p1 = false;
          } else {
            __syncthreads();  // T1 is refilled for the next group
          }
        }
      } else {
        const int lcount = min(lc, K - l0);
        phase3(tile, b0, ll, iq * qt, min(lt, lcount - ll));
        if (++iq == cdiv(min(bc, L.Da8 - b0), qt)) {
          iq = 0;
          if ((ll += lt) >= lcount) {
            ll = 0;
            if (++il < L.nlc) {
              __syncthreads();  // T2 is refilled for the next chunk
              if (L.nkg == 1)
                phase2(il * lc, 0);  // T1 holds every slab k: computed once per chunk
              else
                p1 = true;
            } else {
              il = 0;
              p1 = true;
              if (++ib == L.nbc) break;
            }
          }
        }
      }
    }

    // ---- the site's result: the split depth summed in slice order, then
    // out[i] and this CTA's rows of the next env
    if (split > 1) {
      float* scratch = reinterpret_cast<float*>(sT1);
      constexpr int F = W::kComplex ? 8 : 4;
      if (slice > 0 && n3 > 0) {
        float* o = scratch + ((size_t)((slice - 1) * L.N3 + first3) * 32 + lane) * F;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T v = W::get(acc3[0], q);
          if constexpr (W::kComplex) {
            o[2 * q] = v.x;
            o[2 * q + 1] = v.y;
          } else {
            o[q] = v;
          }
        }
      }
      __syncthreads();
      if (slice == 0) {
        for (int s2 = 1; s2 < split; ++s2) {
          const float* o = scratch + ((size_t)((s2 - 1) * L.N3 + first3) * 32 + lane) * F;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            T v;
            if constexpr (W::kComplex)
              v = make_float2(o[2 * q], o[2 * q + 1]);
            else
              v = o[q];
            W::put(acc3[0], q, W::add(W::get(acc3[0], q), v));
          }
        }
      }
    }
    if (slice == 0) {
      T* out_i = out + ((size_t)i * B + z0) * Dc * Dc;
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (j < n3) {
          const int idx = first3 + j;
          const int md = idx / NN, nn = idx - md * NN, e = nn / NC, cb = nn - e * NC;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int d = md * 16 + g + (q >> 1) * 8, cl = cb * 8 + 2 * t + (q & 1);
            if (e < nz && d < Dc && c0 + cl < Dc) {
              const T v = W::get(acc3[j], q);
              out_i[((size_t)e * Dc + c0 + cl) * Dc + d] = v;
              if (env_next) env_next[e * EE + cl * L.Pe + d] = v;
            }
          }
        }
      }
    }
    if (arrived) cluster_wait();
    arrived = false;
    cluster_sync();  // the next env is in place in every CTA; no CTA reads this one again
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The arguments of one narrow sweep launch, as the C entry points take them.
struct Sweep {
  const void* env0;
  const void* a;
  const void* mx;
  int n, B, Da, K, Dc, zb, ct, stages;
  void* out;
};

template <class Ops, bool Backward, int Tile>
int launch_t(const Sweep& p, size_t smem, cudaStream_t stream) {
  using T = typename Ops::T;
  auto kernel = transfer_sweep_kernel<Ops, Backward, Tile>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((p.B + p.zb - 1) / p.zb);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(p.env0), static_cast<const T*>(p.a),
      static_cast<const T*>(p.mx), p.n, p.B, p.Da, p.K, p.Dc, p.zb, p.ct, p.stages,
      static_cast<T*>(p.out));
  return (int)cudaGetLastError();
}

template <class Ops, bool Backward>
int launch_b(int tile, const Sweep& p, size_t smem, cudaStream_t stream) {
  switch (tile) {
    case 1:
      return launch_t<Ops, Backward, 1>(p, smem, stream);
    case 2:
      return launch_t<Ops, Backward, 2>(p, smem, stream);
    case 4:
      return launch_t<Ops, Backward, 4>(p, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <class Ops>
int launch(int device, const Sweep& p, int backward, int tile, void* stream) {
  using T = typename Ops::T;
  if (p.n < 1 || p.B < 1 || p.Da < 1 || p.K < 1 || p.Dc < 1 || p.zb < 1 || p.ct < 1 ||
      p.ct > p.Dc || p.stages < 1 || p.stages > kMaxStages || p.stages > p.n ||
      (p.n > 1 && p.Da != p.Dc))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * smem_elems(p.n, p.Da, p.K, p.Dc, p.zb, p.ct, p.stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  return backward ? launch_b<Ops, true>(tile, p, smem, s)
                  : launch_b<Ops, false>(tile, p, smem, s);
}

template <class W, bool Backward, int MT3>
int launch_wide_m(const void* env0, const void* a, const void* mx, const WidePlan& p,
                  size_t smem, void* out, cudaStream_t stream) {
  using T = typename W::T;
  auto kernel = transfer_wide_kernel<W, Backward, MT3>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p.C > kPortableCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)p.C, (unsigned)cdiv(p.B, p.zb), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(env0),
                           static_cast<const T*>(a), static_cast<const T*>(mx), p,
                           static_cast<T*>(out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class W>
int launch_wide(int device, const void* env0, const void* a, const void* mx,
                const WidePlan& p, int backward, size_t smem, void* out, void* stream) {
  const WideLayout L = wide_layout(p, W::kComplex, backward != 0);
  if (!wide_ok(p, L, W::kComplex, smem, sizeof(typename W::T)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);
  if (L.N3 <= kWarps)  // one tile per warp (the depth split over warps where fewer)
    return backward ? launch_wide_m<W, true, 1>(env0, a, mx, p, smem, out, s)
                    : launch_wide_m<W, false, 1>(env0, a, mx, p, smem, out, s);
  return backward ? launch_wide_m<W, true, kMaxTiles3>(env0, a, mx, p, smem, out, s)
                  : launch_wide_m<W, false, kMaxTiles3>(env0, a, mx, p, smem, out, s);
}

}  // namespace

extern "C" {

// B3 (float32), narrow route.  Forward: env0 [B, Da, Da], a [n, Da, K, Dc],
// mx [n, B, K, K] -> out [n, B, Dc, Dc].  backward = 1: the d_env chain; a is
// the forward's stack [n, Dc, K, Da] (read transposed, sites in reverse),
// env0 the cotangent [B, Da, Da] of the last site's output, out[i] [B, Dc,
// Dc] the cotangent of site i's input.  (Da, K, Dc) are the step's own dims.
int tneq_transfer_sweep_f32(int device, const void* env0, const void* a, const void* mx,
                            int n, int B, int Da, int K, int Dc, int backward, int zb,
                            int ct, int tile, int stages, void* out, void* stream) {
  return launch<Real>(device, Sweep{env0, a, mx, n, B, Da, K, Dc, zb, ct, stages, out},
                      backward, tile, stream);
}

// B4 (complex64, interleaved re/im as float2; the bra is conj(A), and the
// backward chain runs on conj(A)^T and conj(Mx)), narrow route.
int tneq_transfer_sweep_c64(int device, const void* env0, const void* a, const void* mx,
                            int n, int B, int Da, int K, int Dc, int backward, int zb,
                            int ct, int tile, int stages, void* out, void* stream) {
  return launch<Complex>(device, Sweep{env0, a, mx, n, B, Da, K, Dc, zb, ct, stages, out},
                         backward, tile, stream);
}

// The wide route of B3 and B4: the same arguments and outputs, and the wide
// plan (cluster, entries, strip, chunks, tiles, ring, shared memory).
int tneq_transfer_wide_f32(int device, const void* env0, const void* a, const void* mx,
                           int n, int B, int Da, int K, int Dc, int backward, int zb, int cs,
                           int cluster, int bc, int kg, int lc, int ka, int qt, int lt,
                           int stages, size_t smem, void* out, void* stream) {
  const WidePlan p{n, B, Da, K, Dc, zb, cs, cluster, bc, kg, lc, ka, qt, lt, stages};
  return launch_wide<WReal>(device, env0, a, mx, p, backward, smem, out, stream);
}

int tneq_transfer_wide_c64(int device, const void* env0, const void* a, const void* mx,
                           int n, int B, int Da, int K, int Dc, int backward, int zb, int cs,
                           int cluster, int bc, int kg, int lc, int ka, int qt, int lt,
                           int stages, size_t smem, void* out, void* stream) {
  const WidePlan p{n, B, Da, K, Dc, zb, cs, cluster, bc, kg, lc, ka, qt, lt, stages};
  return launch_wide<WComplex>(device, env0, a, mx, p, backward, smem, out, stream);
}

}  // extern "C"

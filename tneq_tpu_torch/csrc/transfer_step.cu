// Hand-written Hopper (sm_90a) kernel for the MPS transfer sweep of the
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
// flops).  Here the step is factorised, 2 B (2 D^3 K + D^2 K^2) flops
// (13x fewer at D = 8, K = 4):
//     T1[z,b,k,c] = sum_a   env[z,a,b] ket(A)[a,k,c]
//     T2[z,b,l,c] = sum_k   T1[z,b,k,c] op(Mx)[z,k,l]
//     out[z,c,d]  = sum_b,l T2[z,b,l,c] bra(A)[b,l,d]
// At the shapes of the Born-rule paths a step is microseconds of latency,
// not bytes or flops, and each batch entry's chain of sites is independent
// of every other's, so:
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
//   * Wide cores.  Where not even one stage of A fits next to the env and
//     the T1/T2 strips (a core of 256 KiB: D = 64, K = 16 in float32 or
//     D = K = 32 in complex64), the plan sets stages = 0 and the kernel is
//     instantiated without the ring: A and the group's Mx are read straight
//     from global memory (L2), and the backward reads a core stack the
//     wrapper has transposed.  Only the env and T1/T2 live in shared memory.
//   * zb from the batch.  The plan (ops/transfer_step.kernel_plan) spreads
//     the batch over the card's 132 SMs, up to 32 entries per block, so one
//     copy of A per block and site serves many entries at wide D.
//   * Register tiles.  Each product phase gives a thread a tile x tile block
//     of outputs (tile 1, 2 or 4 from the plan): per summed index it loads
//     2*tile shared values for tile^2 FMAs.  Where one group's T1/T2 would
//     outgrow shared memory, a site walks over strips of ct columns c.
//     T1/T2 rows and entries have odd pitches against bank conflicts.
//   * Summation order: each output sums its index from 0 upwards in one
//     accumulator, as the plain version's loops do.  B4 uses native complex
//     FMAs on float2, not the TPU's stacked real form.
//
// What bounds it on an H100.  At the born_rule width (B = 512, D = 8, K = 4,
// n = 5, f32) the sweep reads and writes ~1.4 MB and does 26 MFLOP: 0.4 us
// by operations; the launch and the n dependent sites are the cost.  At
// (4096, 16, 4) a site is ~300 MFLOP, bound by operations.  Later work:
// mma.sync / wgmma over the batch (3xTF32 to keep f32 accuracy).
//
// Interface: plain C, loaded with ctypes.  Each entry point returns
// cudaGetLastError() after its launch (0 = success); it launches on the
// caller's stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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
// computes the same): `stages` copies of A and of the group's Mx (none when
// stages = 0), `envs` env buffers (2 when the sweep has more than one site),
// T1 and T2.
__host__ __device__ inline size_t smem_elems(int n, int Da, int K, int Dc, int zb, int ct,
                                             int stages) {
  const int envs = n > 1 ? 2 : 1;
  return (size_t)stages * ((size_t)Da * K * Dc + (size_t)zb * K * K) +
         (size_t)zb * ((size_t)envs * Da * Da + 2 * (size_t)entry_pitch(Da, K, ct));
}

// Staged: A and Mx pass through the cp.async ring of `stages` buffers;
// otherwise (stages = 0) they are read from global memory, and for the
// backward `a` holds the cores already transposed to the step's layout.
template <class Ops, bool Backward, int Tile, bool Staged>
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

  // Prologue: env0 and the first `stages` sites, one group per site (env0
  // alone when nothing is staged).
  copy_async(sEnv, env0 + (size_t)z0 * DD, nz * DD);
  if constexpr (Staged) {
    for (int s = 0; s < min(n, stages); ++s) load_site(s, s);
  } else {
    cp_async_commit();
  }

  for (int s = 0; s < n; ++s) {
    const int i = Backward ? n - 1 - s : s;
    const T* A_;
    const T* M_;
    if constexpr (Staged) {
      const int st = s % stages;
      // sites staged so far: the prologue's, one more per site since site 1
      const int issued = stages == 1 ? s + 1 : min(n, stages + max(s - 1, 0));
      cp_async_wait(issued - s - 1);
      __syncthreads();  // site s staged; every thread is done with site s-1
      if (stages > 1 && s > 0 && s + stages - 1 < n)
        load_site(s + stages - 1, (s - 1) % stages);  // into site s-1's buffer
      A_ = sA + st * DKC;
      M_ = sMx + st * zb * KK;
    } else {
      if (s == 0) cp_async_wait(0);  // env0
      __syncthreads();  // env0 in place; every thread is done with site s-1
      A_ = a + (size_t)i * DKC;
      M_ = mx + ((size_t)i * B + z0) * KK;
    }
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
    if constexpr (Staged) {
      if (stages == 1 && s + 1 < n) {
        __syncthreads();  // every thread is done with the one stage
        load_site(s + 1, 0);
      }
    }
  }
}

// The arguments of one sweep launch, as the C entry points take them.
struct Sweep {
  const void* env0;
  const void* a;
  const void* mx;
  int n, B, Da, K, Dc, zb, ct, stages;
  void* out;
};

template <class Ops, bool Backward, int Tile, bool Staged>
int launch_t(const Sweep& p, size_t smem, cudaStream_t stream) {
  using T = typename Ops::T;
  auto kernel = transfer_sweep_kernel<Ops, Backward, Tile, Staged>;
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

template <class Ops, bool Backward, bool Staged>
int launch_s(int tile, const Sweep& p, size_t smem, cudaStream_t stream) {
  switch (tile) {
    case 1:
      return launch_t<Ops, Backward, 1, Staged>(p, smem, stream);
    case 2:
      return launch_t<Ops, Backward, 2, Staged>(p, smem, stream);
    case 4:
      return launch_t<Ops, Backward, 4, Staged>(p, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <class Ops, bool Backward>
int launch_b(int tile, const Sweep& p, size_t smem, cudaStream_t stream) {
  return p.stages > 0 ? launch_s<Ops, Backward, true>(tile, p, smem, stream)
                      : launch_s<Ops, Backward, false>(tile, p, smem, stream);
}

template <class Ops>
int launch(int device, const Sweep& p, int backward, int tile, void* stream) {
  using T = typename Ops::T;
  if (p.n < 1 || p.B < 1 || p.Da < 1 || p.K < 1 || p.Dc < 1 || p.zb < 1 || p.ct < 1 ||
      p.ct > p.Dc || p.stages < 0 || p.stages > kMaxStages || p.stages > p.n ||
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

}  // namespace

extern "C" {

// B3 (float32).  Forward: env0 [B, Da, Da], a [n, Da, K, Dc], mx [n, B, K, K]
// -> out [n, B, Dc, Dc].  backward = 1: the d_env chain; a is the forward's
// stack [n, Dc, K, Da] (read transposed, sites in reverse), or with
// stages = 0 that stack already transposed to [n, Da, K, Dc]; env0 is the
// cotangent [B, Da, Da] of the last site's output, out[i] [B, Dc, Dc] the
// cotangent of site i's input.  (Da, K, Dc) are the step's own dims.
int tneq_transfer_sweep_f32(int device, const void* env0, const void* a, const void* mx,
                            int n, int B, int Da, int K, int Dc, int backward, int zb,
                            int ct, int tile, int stages, void* out, void* stream) {
  return launch<Real>(device, Sweep{env0, a, mx, n, B, Da, K, Dc, zb, ct, stages, out},
                      backward, tile, stream);
}

// B4 (complex64, interleaved re/im as float2; the bra is conj(A), and the
// backward chain runs on conj(A)^T and conj(Mx)).
int tneq_transfer_sweep_c64(int device, const void* env0, const void* a, const void* mx,
                            int n, int B, int Da, int K, int Dc, int backward, int zb,
                            int ct, int tile, int stages, void* out, void* stream) {
  return launch<Complex>(device, Sweep{env0, a, mx, n, B, Da, K, Dc, zb, ct, stages, out},
                         backward, tile, stream);
}

}  // extern "C"

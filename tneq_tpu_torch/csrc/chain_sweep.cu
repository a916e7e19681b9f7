// Hand-written Hopper (sm_90a) kernels for the MPS-chain overlap sweep.
//
// Replaces the two Pallas kernels of tneq_tpu/ops/chain_overlap.py::_chain_sweep:
//   B1  fwd_kernel / run_fwd   (pl.pallas_call at chain_overlap.py:160)
//   B2  bwd_kernel / run_bwd   (pl.pallas_call at chain_overlap.py:224),
//       with the VJP glue of sweep_bwd (chain_overlap.py:257-263) in Python.
//
// B1 computes, for u0 [S], M [n, S, S], w [S] (S = bond^2, float32):
//     v <- u0;  for i: ustack[i] = v; raw = v @ M[i]; s_i = max|raw| + 1e-30;
//                      v = raw / s_i
//     f = v . w;  logsum = sum_i log s_i;  ulast = v
// B2 is its exact VJP with the scales held constant: for r0 = df * w,
//     for i = n-1 .. 0: draw_i = r / s_i; r <- M[i] @ draw_i
//     dM[i] = outer(ustack[i], draw_i);  du0 = r
//
// What bounds them on an H100.  B1 reads M once (n*S^2*4 bytes: 7.6 MB at the
// bench shape n=29, S=256, i.e. 2.3 us at 3.35 TB/s) and does 2*n*S^2 flops
// (negligible).  B2 reads M and writes dM (15.2 MB, 4.5 us).  Neither bound
// can be reached: the sweep is a chain of n dependent steps (site i+1 needs
// all of site i's rescaled carry, whose scale is a max over the whole
// vector), so the floor is n times the latency of one site: a slice of the
// GEMV on the critical path, one exchange of the carry between the SMs that
// share the work, and the max.  PERF.md gives the card's time per site.
// At S = 1024 (116 MiB of M, past the L2) the bytes of M come from HBM
// through the cluster's SMs alone.
//
// Design.  The TPU ran the sites as a sequential grid with the carry in VMEM
// scratch.  Here one thread-block cluster of C CTAs (up to 16, on as many
// SMs) walks all n sites, and M -- which does not depend on the carry -- is
// streamed into shared memory ahead of the carry, so the dependency chain
// is left with arithmetic on shared memory and one exchange per site.  The
// launch parameters (C, strip, ring stages, tile rows, shared memory) come
// from ops/chain_overlap.py::sweep_plan, by shape alone; ragged strips and
// any 1 <= S <= 1024 are masked here.
//   Warps, not CTAs.  Within a CTA each warp owns a fixed share of the
//       strip (B1: a block of column quads, B2: every 8th row); it copies,
//       reads, reduces and sends that share alone, so no site has a CTA-wide
//       barrier and the warps of a CTA run ahead of one another freely.
//   Prefetch ring.  Each warp cuts its share of every M_i into tiles of
//       tile_rows rows and consumes them in (site, tile) order through a ring
//       of `stages` tiles in shared memory, filled by cp.async (16-byte
//       copies when S % 4 == 0 and M is 16-byte aligned, 4-byte otherwise;
//       B1's tile rows are padded to an odd number of float4s, so the
//       lanes' float4 reads of 8 consecutive rows meet no bank conflict).
//       Tile t+stages is issued as soon as the warp has consumed tile t.
//       Every tile costs the critical path a fixed latency (wait, refill),
//       so a site's share is cut into as few balanced tiles as leave room
//       for two: at the bench shape a tile is one whole site and the ring
//       holds 11 (B1) or 13 (B2) sites; at S = 1024 three tiles a site.
//   Exchange.  A warp sends its finished values to every CTA of the cluster
//       (itself included) with st.async -- lane q stores into CTA q's shared
//       memory, and the store, on landing, completes its bytes on an
//       mbarrier there.  Each CTA arms its mbarrier for S*4 bytes per site
//       and every warp waits on it: one store-and-signal per site and no
//       cluster-wide barrier.  (A first version with one barrier.cluster
//       per site, whose release semantics wait for all earlier stores, was
//       measurably slower; see PERF.md.)  No buffer is overwritten while it
//       is read, by the data dependence alone: a warp writes the buffer of
//       site i+K into a peer only after its CTA has received all of site
//       i+K-1, which every warp of the peer sends after its last read of
//       the buffer's previous contents (site i) -- given K buffers.
//   B1, column strips.  CTA c owns columns [c*strip, (c+1)*strip) of every
//       M_i.  A lane takes every 32nd row of its warp's quads, the warp sums
//       the lanes by shuffles, and lanes 0..C-1 send the quad (one 16-byte
//       st.async each).  After the exchange every warp holds all of raw_i
//       and forms s_i itself: max |raw| as an unsigned max over the bits
//       (redux.sync), which keeps NaN.  The carry of site i+1 is read as
//       raw_i * (1/s_i) straight from the exchange buffer, which is
//       double-buffered by the parity of i (K = 2).  CTA 0 writes the
//       scales and, after the last site, f = u_n . w and sum_i log s_i (in
//       site order, as the plain version adds them).
//   B2, row strips, dM fused.  CTA c owns rows [c*strip, (c+1)*strip) of
//       every M_i (one contiguous block), walks the sites in reverse and
//       forms r[j] = M_i[j, :] . draw_i for a warp's rows j, two at a time
//       so that their reductions overlap, sends draw_{i-1}[j] = r[j] /
//       s_{i-1}, and then writes the rows dM[i, j, :] = ustack[i, j] *
//       draw_i -- contiguous, from what it already holds (ustack[i, j]
//       rides in the ring with the tile) -- while the exchange is in flight.  draw_i is read until those
//       stores, after the send of site i-1, so the draw buffer is
//       triple-buffered (K = 3).  One launch: no draws round trip.
//   One cluster barrier after the set-up and one before exit keep every
//   CTA resident while a store may target it.
//   Lanes.  A launch runs `lanes` independent sweeps of one shape (the
//       lanes of the batched prune, torch.func.vmap in the port): the grid
//       is cluster x lanes, and the clusters of row blockIdx.y work on lane
//       blockIdx.y, whose operands sit at lane strides (S for u0, w, ulast,
//       r0 and du0; n*S*S for M and dM; n*S for ustack; n for scales; 1 for
//       f and logsum).  sweep_plan halves the cluster while lanes x cluster
//       CTAs would outgrow the card's 132 SMs.
// Later work: the three B1 sweeps of a step in one launch, and CUDA graphs
// around the step.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns a CUDA
// error code (0 = success); it launches on the caller's stream, does not
// synchronise and allocates nothing.  A cluster launch the card refuses
// returns its error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 1024;
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr int kMaxStages = 16;
constexpr int kMaxStrip = 128;  // B1: at most 4 column quads per warp
constexpr int kQuadsPerWarp = kMaxStrip / 4 / kWarps;
constexpr int kBarFloats = 8;   // the head of shared memory: up to 4 mbarriers
constexpr size_t kSmemMax = 232448;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most `pending` (< kMaxStages) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
  switch (pending) {
#define TNEQ_WAIT_CASE(k) \
  case k:                 \
    cp_async_wait<k>();   \
    break;
    TNEQ_WAIT_CASE(0) TNEQ_WAIT_CASE(1) TNEQ_WAIT_CASE(2) TNEQ_WAIT_CASE(3)
    TNEQ_WAIT_CASE(4) TNEQ_WAIT_CASE(5) TNEQ_WAIT_CASE(6) TNEQ_WAIT_CASE(7)
    TNEQ_WAIT_CASE(8) TNEQ_WAIT_CASE(9) TNEQ_WAIT_CASE(10) TNEQ_WAIT_CASE(11)
    TNEQ_WAIT_CASE(12) TNEQ_WAIT_CASE(13) TNEQ_WAIT_CASE(14)
#undef TNEQ_WAIT_CASE
    default:
      cp_async_wait<kMaxStages - 1>();
  }
}

// All threads of the cluster, with release/acquire: used once after the
// mbarriers are set up and once before exit.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one local arrival of a phase, expecting `bytes` from st.async stores.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete; makes the stores that
// completed it visible to this thread.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The shared::cluster address of the same shared-memory offset in CTA `rank`.
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Store x at `addr` (shared::cluster) and complete 4 bytes on the mbarrier
// at `bar` (shared::cluster, same CTA as addr).
__device__ __forceinline__ void st_async(unsigned addr, float x, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(
          addr),
      "f"(x), "r"(bar)
      : "memory");
}

// The same for four floats at a 16-byte aligned `addr`, completing 16 bytes.
__device__ __forceinline__ void st_async4(unsigned addr, const float (&x)[4],
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
          addr),
      "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "r"(bar)
      : "memory");
}

// B1's ring tile: rows of the CTA's columns at a pitch of an odd number of
// float4s, so that a warp reading one float4 of 8 consecutive rows hits 8
// different bank groups.  The same rule as sweep_plan's.
__host__ __device__ constexpr int tile_pitch(int strip) {
  return ((strip + 3) & ~3) + ((((strip + 3) >> 2) & 1) ? 0 : 4);
}

// Shared-memory layout in floats, the same sums as sweep_plan's smem_bytes.
__host__ __device__ constexpr size_t fwd_smem_floats(int S, int strip,
                                                     int stages, int tile_rows) {
  // mbarriers, ring, exchange [2][S]
  return kBarFloats + (size_t)stages * tile_rows * tile_pitch(strip) +
         2 * (size_t)S;
}

// B2's ring stage: the tile's rows of M, then their entries of ustack.
__host__ __device__ constexpr size_t bwd_stage_floats(int S, int tile_rows) {
  return (size_t)tile_rows * S + ((tile_rows + 3) & ~3);
}

__host__ __device__ constexpr size_t bwd_smem_floats(int S, int strip,
                                                     int stages, int tile_rows) {
  // mbarriers, ring, draws [3][S]
  return kBarFloats + (size_t)stages * bwd_stage_floats(S, tile_rows) +
         3 * (size_t)S;
}

// Wait until this thread's copies of the oldest in-flight tile have landed,
// then make the warp's copies visible to the whole warp.
__device__ __forceinline__ void wait_tile(int stages) {
  cp_async_wait_dyn(stages - 1);
  __syncwarp();
}

// B1: forward sweep.  One cluster of C CTAs; CTA c owns a column strip, and
// each warp of it a block of column quads.  A warp copies, reads and sends
// only its own quads, so the warps of a CTA never wait for each other.
template <bool V4>
__global__ void __launch_bounds__(kThreads, 1)
sweep_fwd_kernel(const float* __restrict__ u0, const float* __restrict__ M,
                 const float* __restrict__ w, int n, int S, int strip,
                 int stages, int tile_rows, float* __restrict__ ustack,
                 float* __restrict__ scales, float* __restrict__ f_out,
                 float* __restrict__ logsum_out, float* __restrict__ ulast) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = c * strip;
  const int wc = min(strip, S - c0);  // >= 1: the plan leaves no CTA empty
  {  // this cluster's lane
    const size_t L = blockIdx.y;
    u0 += L * S;
    M += L * n * (size_t)S * S;
    w += L * S;
    ustack += L * n * (size_t)S;
    scales += L * n;
    f_out += L;
    logsum_out += L;
    ulast += L * S;
  }
  // column quads: warp w owns the contiguous quads [w*qpw, w*qpw + nq), so
  // that its 16-byte copies fill whole 32-byte sectors
  const int NQ = (wc + 3) >> 2;
  const int qpw = (NQ + kWarps - 1) / kWarps;
  const int q0 = warp * qpw;
  const int nq = max(0, min(qpw, NQ - q0));

  const int P = tile_pitch(strip);
  const int stage_floats = tile_rows * P;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [2]: one per exchange buffer
  float* ring = smem + kBarFloats;
  float* xbuf = ring + (size_t)stages * stage_floats;  // [2][S]: raw of site i in i & 1
  const unsigned bytes = 4u * S;  // what lands in a CTA per site

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_init_fence();
    mbar_expect(&bars[0], bytes);  // site 0
    if (n > 1) mbar_expect(&bars[1], bytes);  // site 1
  }
  // the carry of site 0 is u0, kept where the raw of site -1 would be
  for (int j = tid; j < S; j += kThreads) xbuf[S + j] = u0[j];
  cluster_sync();  // the mbarriers are set up in every CTA, u0 is in place
  if (nq == 0) {   // a warp without columns
    cluster_sync();
    return;
  }

  const int T = (S + tile_rows - 1) / tile_rows;  // tiles per site
  const int ntiles = n * T;
  auto issue = [&](int t) {  // this warp's quads of tile t into its stage
    if (t < ntiles) {
      const int i = t / T;
      const int r0 = (t - i * T) * tile_rows;
      const int rows = min(tile_rows, S - r0);
      float* dst = ring + (t % stages) * stage_floats;
      const float* src = M + (size_t)i * S * S + (size_t)r0 * S + c0;
      if (V4) {
        for (int e = lane; e < rows * nq; e += 32) {
          const int a = e / nq;
          const int col = 4 * (q0 + e - a * nq);
          cp_async16(dst + a * P + col, src + (size_t)a * S + col);
        }
      } else {
        for (int e = lane; e < rows * nq * 4; e += 32) {
          const int a = e / (nq * 4);
          const int r = e - a * nq * 4;
          const int col = 4 * q0 + r;
          if (col < wc) cp_async4(dst + a * P + col, src + (size_t)a * S + col);
        }
      }
    }
    cp_async_commit();  // one group per tile, empty past the end
  };
  for (int t = 0; t < stages; ++t) issue(t);

  float inv = 1.f;  // 1 / s_{i-1}: the carry of site i is raw_{i-1} * inv
  int t = 0;
  for (int i = 0; i < n; ++i) {
    const int p = i & 1;
    const float* carry = xbuf + (p ^ 1) * S;
    for (int qi = 0; qi < nq; ++qi) {  // ustack[i] = carry, the warp's quads
      const int col = c0 + 4 * (q0 + qi) + (lane & 3);
      if (lane < 4 && col < c0 + wc) ustack[(size_t)i * S + col] = carry[col] * inv;
    }
    float acc[kQuadsPerWarp][4] = {};
    for (int k = 0; k < T; ++k, ++t) {
      wait_tile(stages);
      const float* tile = ring + (t % stages) * stage_floats;
      const int r0 = k * tile_rows;
      const int rows = min(tile_rows, S - r0);
      // lane takes every 32nd row of the warp's quads
#pragma unroll
      for (int qi = 0; qi < kQuadsPerWarp; ++qi) {
        if (qi < nq) {
          const int col = 4 * (q0 + qi);
#pragma unroll 4
          for (int a = lane; a < rows; a += 32) {
            const float va = carry[r0 + a] * inv;
            const float4 m4 = *reinterpret_cast<const float4*>(tile + a * P + col);
            acc[qi][0] = fmaf(va, m4.x, acc[qi][0]);
            acc[qi][1] = fmaf(va, m4.y, acc[qi][1]);
            acc[qi][2] = fmaf(va, m4.z, acc[qi][2]);
            acc[qi][3] = fmaf(va, m4.w, acc[qi][3]);
          }
        }
      }
      if (k + 1 < T) {
        __syncwarp();  // the warp's part of the stage is consumed
        issue(t + stages);
      }
    }
    // sum each quad over the warp; lane q sends it to CTA q
#pragma unroll
    for (int qi = 0; qi < kQuadsPerWarp; ++qi) {
      if (qi < nq) {
        const int col = c0 + 4 * (q0 + qi);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            acc[qi][e] += __shfl_xor_sync(0xffffffffu, acc[qi][e], o);
        if (lane < C) {
          const unsigned bar = mapa(smem_u32(&bars[p]), lane);
          if (V4) {
            st_async4(mapa(smem_u32(xbuf + p * S + col), lane), acc[qi], bar);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < c0 + wc)
                st_async(mapa(smem_u32(xbuf + p * S + col + e), lane), acc[qi][e], bar);
          }
        }
      }
    }
    __syncwarp();  // the site's last stage is consumed
    issue(t - 1 + stages);
    mbar_wait(&bars[p], (i >> 1) & 1);  // all of raw_i has landed here
    if (tid == 0 && i + 2 < n) mbar_expect(&bars[p], bytes);  // site i+2

    // s_i over all of raw_i, by every warp alone: the max of |raw| as an
    // unsigned max of the bits with the sign cleared, which orders the
    // non-negative floats and puts any NaN above +inf: a NaN propagates,
    // as in torch.max
    const float* raw = xbuf + p * S;
    unsigned mb = 0u;
    for (int j = lane; j < S; j += 32) mb = max(mb, __float_as_uint(raw[j]) & 0x7fffffffu);
    const float s = __uint_as_float(__reduce_max_sync(0xffffffffu, mb)) + kTiny;
    inv = 1.f / s;
    if (c == 0 && tid == 0) scales[i] = s;
  }

  // u_n = raw_{n-1} * inv, in every CTA
  const float* raw = xbuf + ((n - 1) & 1) * S;
  for (int qi = 0; qi < nq; ++qi) {
    const int col = c0 + 4 * (q0 + qi) + (lane & 3);
    if (lane < 4 && col < c0 + wc) ulast[col] = raw[col] * inv;
  }
  if (c == 0 && warp == 0) {  // f = u_n . w and sum_i log s_i
    float f = 0.f;
    for (int j = lane; j < S; j += 32) f += raw[j] * inv * w[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) f += __shfl_xor_sync(0xffffffffu, f, o);
    if (lane == 0) {
      // in site order, as the plain version adds them: the fidelity is a
      // difference of such sums, and float32 shows their order
      float ls = 0.f;
      for (int j = 0; j < n; ++j) ls += logf(scales[j]);
      *f_out = f;
      *logsum_out = ls;
    }
  }
  cluster_sync();  // no CTA leaves while a store may still target it
}

// B2: reverse sweep with dM fused.  One cluster; CTA c owns a row strip,
// and warp w of it the rows w, w+8, ...: a warp copies, reads, reduces,
// sends and writes dM for its own rows only.
template <bool V4>
__global__ void __launch_bounds__(kThreads, 1)
sweep_bwd_kernel(const float* __restrict__ r0, const float* __restrict__ M,
                 const float* __restrict__ ustack,
                 const float* __restrict__ scales, int n, int S, int strip,
                 int stages, int tile_rows, float* __restrict__ dM,
                 float* __restrict__ du0) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = c * strip;
  const int hc = min(strip, S - c0);  // rows of this CTA, >= 1
  {  // this cluster's lane
    const size_t L = blockIdx.y;
    r0 += L * S;
    M += L * n * (size_t)S * S;
    ustack += L * n * (size_t)S;
    scales += L * n;
    dM += L * n * (size_t)S * S;
    du0 += L * S;
  }

  const int stage_floats = (int)bwd_stage_floats(S, tile_rows);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [3]: one per draw buffer
  float* ring = smem + kBarFloats;
  float* dbuf = ring + (size_t)stages * stage_floats;  // [3][S] draw_i in i % 3
  const unsigned bytes = 4u * S;
  // Sites n-2 .. 0 are exchanged; site j uses buffer j % 3, and it is that
  // buffer's ((n-2-j)/3)-th exchange.
  auto parity = [&](int j) { return (unsigned)(((n - 2 - j) / 3) & 1); };

  if (tid == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(&bars[b]);
    mbar_init_fence();
    for (int j = n - 2; j >= 0 && j >= n - 4; --j) mbar_expect(&bars[j % 3], bytes);
  }
  {
    const float s = scales[n - 1];
    float* d = dbuf + ((n - 1) % 3) * S;
    for (int j = tid; j < S; j += kThreads) d[j] = r0[j] / s;
  }
  cluster_sync();  // the mbarriers are set up in every CTA, draw_{n-1} is complete
  if (warp >= hc) {  // a warp without rows
    cluster_sync();
    return;
  }

  const int T = (hc + tile_rows - 1) / tile_rows;  // tiles per site
  const int ntiles = n * T;
  const int units = V4 ? S >> 2 : S;  // float4s or floats of a row
  auto issue = [&](int t) {  // this warp's rows of tile t, and their ustack
    if (t < ntiles) {
      const int i = n - 1 - t / T;
      const int a0 = (t % T) * tile_rows;
      const int rows = min(tile_rows, hc - a0);
      float* dst = ring + (t % stages) * stage_floats;
      const float* src = M + ((size_t)i * S + c0 + a0) * S;
      for (int a = warp; a < rows; a += kWarps) {
        for (int q = lane; q < units; q += 32) {
          if (V4)
            cp_async16(dst + a * S + 4 * q, src + (size_t)a * S + 4 * q);
          else
            cp_async4(dst + a * S + q, src + (size_t)a * S + q);
        }
        if (lane == 0)
          cp_async4(dst + tile_rows * S + a, ustack + (size_t)i * S + c0 + a0 + a);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < stages; ++t) issue(t);

  int t = 0;
  float s_prev = n > 1 ? scales[n - 2] : 1.f;  // s_{i-1}, loaded a site ahead
  for (int i = n - 1; i >= 0; --i) {
    const int b = i % 3;
    const int bn = (i + 2) % 3;  // (i-1) % 3: the buffer of draw_{i-1}
    const float* d = dbuf + b * S;
    const float inv_prev = 1.f / s_prev;
    s_prev = i > 1 ? scales[i - 2] : 1.f;
    if (i < n - 1) {
      mbar_wait(&bars[b], parity(i));  // all of draw_i has landed here
      if (tid == 0 && i >= 3) mbar_expect(&bars[b], bytes);  // site i-3
    }
    for (int k = 0; k < T; ++k, ++t) {
      wait_tile(stages);
      const float* tile = ring + (t % stages) * stage_floats;
      const float* us = tile + tile_rows * S;  // ustack[i, rows of the tile]
      const int a0 = k * tile_rows;
      const int rows = min(tile_rows, hc - a0);
      // the warp's rows two at a time, so that their reductions overlap
      for (int a = warp; a < rows; a += 2 * kWarps) {
        const bool two = a + kWarps < rows;
        const float* row0 = tile + a * S;
        const float* row1 = tile + (two ? a + kWarps : a) * S;
        float acc[2] = {0.f, 0.f};
        if (V4) {
          for (int q = lane; q < units; q += 32) {
            const float4 d4 = reinterpret_cast<const float4*>(d)[q];
            const float4 m0 = reinterpret_cast<const float4*>(row0)[q];
            const float4 m1 = reinterpret_cast<const float4*>(row1)[q];
            acc[0] = fmaf(m0.x, d4.x, acc[0]);
            acc[0] = fmaf(m0.y, d4.y, acc[0]);
            acc[0] = fmaf(m0.z, d4.z, acc[0]);
            acc[0] = fmaf(m0.w, d4.w, acc[0]);
            acc[1] = fmaf(m1.x, d4.x, acc[1]);
            acc[1] = fmaf(m1.y, d4.y, acc[1]);
            acc[1] = fmaf(m1.z, d4.z, acc[1]);
            acc[1] = fmaf(m1.w, d4.w, acc[1]);
          }
        } else {
          for (int q = lane; q < S; q += 32) {
            acc[0] = fmaf(row0[q], d[q], acc[0]);
            acc[1] = fmaf(row1[q], d[q], acc[1]);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
          acc[1] += __shfl_xor_sync(0xffffffffu, acc[1], o);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && !two) break;
          const int al = a + h * kWarps;  // the row in the tile
          const int j = c0 + a0 + al;     // the row of M_i
          // lane q sends draw_{i-1}[j] to CTA q
          if (i > 0) {
            if (lane < C)
              st_async(mapa(smem_u32(dbuf + bn * S + j), lane), acc[h] * inv_prev,
                       mapa(smem_u32(&bars[bn]), lane));
          } else if (lane == 0) {
            du0[j] = acc[h];
          }
          // dM[i, j, :] = ustack[i, j] * draw_i, a contiguous row, while the
          // exchange is in flight
          const float u = us[al];
          float* out = dM + ((size_t)i * S + j) * S;
          if (V4) {
            for (int q = lane; q < units; q += 32) {
              const float4 d4 = reinterpret_cast<const float4*>(d)[q];
              reinterpret_cast<float4*>(out)[q] =
                  make_float4(u * d4.x, u * d4.y, u * d4.z, u * d4.w);
            }
          } else {
            for (int q = lane; q < S; q += 32) out[q] = u * d[q];
          }
        }
      }
      __syncwarp();  // the warp's part of the stage is consumed
      issue(t + stages);
    }
  }
  cluster_sync();  // no CTA leaves while a store may still target it
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The plan's values, checked against what the kernels assume.
inline bool plan_ok(int lanes, int n, int S, int cluster, int strip, int stages,
                    int tile_rows, size_t smem, size_t need) {
  return lanes >= 1 && lanes <= 65535 && n >= 1 && S >= 1 && S <= kMaxS && cluster >= 1 &&
         cluster <= kMaxCluster && strip >= 1 && strip <= kMaxStrip &&
         (size_t)cluster * strip >= (size_t)S && (cluster - 1) * strip < S &&
         stages >= 1 && stages <= kMaxStages && tile_rows >= 1 &&
         need * sizeof(float) <= smem && smem <= kSmemMax;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cluster > kPortableCluster)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int cluster, int lanes, size_t smem, cudaStream_t st) {
    cfg.gridDim = dim3(cluster, lanes, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

cudaError_t max_active_clusters(const void* kernel, int cluster, int* out) {
  cudaError_t err = prepare(kernel, kSmemMax, cluster);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(cluster, 1, kSmemMax, nullptr);
  return cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg);
}

}  // namespace

extern "C" {

// The largest cluster the sweep kernels may use on this card for a launch
// of `lanes` sweeps: 16 where `lanes` clusters of 16 CTAs with the most
// shared memory a plan asks for can be resident at once
// (cudaOccupancyMaxActiveClusters), else the portable 8.
int tneq_chain_sweep_max_cluster(int device, int lanes, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int fits = 1 << 30;
  const void* kernels[] = {(const void*)sweep_fwd_kernel<true>,
                           (const void*)sweep_fwd_kernel<false>,
                           (const void*)sweep_bwd_kernel<true>,
                           (const void*)sweep_bwd_kernel<false>};
  for (const void* k : kernels) {
    int m = 0;
    err = max_active_clusters(k, kMaxCluster, &m);
    if (err != cudaSuccess) return (int)err;
    fits = m < fits ? m : fits;
  }
  *out = fits >= (lanes > 1 ? lanes : 1) ? kMaxCluster : kPortableCluster;
  return 0;
}

// B1 over `lanes` sweeps.  Inputs u0 [lanes, S], M [lanes, n, S, S],
// w [lanes, S]; outputs ustack [lanes, n, S], scales [lanes, n],
// f [lanes], logsum [lanes], ulast [lanes, S].
int tneq_chain_sweep_fwd(int device, const float* u0, const float* M,
                         const float* w, int lanes, int n, int S, int cluster,
                         int strip, int stages, int tile_rows, size_t smem,
                         float* ustack, float* scales, float* f, float* logsum,
                         float* ulast, void* stream) {
  if (!plan_ok(lanes, n, S, cluster, strip, stages, tile_rows, smem,
               fwd_smem_floats(S, strip, stages, tile_rows)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(cluster, lanes, smem, static_cast<cudaStream_t>(stream));
  if (S % 4 == 0 && strip % 4 == 0 && aligned16(M)) {
    auto* k = sweep_fwd_kernel<true>;
    if ((err = prepare(k, smem, cluster)) != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&l.cfg, k, u0, M, w, n, S, strip, stages,
                             tile_rows, ustack, scales, f, logsum, ulast);
  } else {
    auto* k = sweep_fwd_kernel<false>;
    if ((err = prepare(k, smem, cluster)) != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&l.cfg, k, u0, M, w, n, S, strip, stages,
                             tile_rows, ustack, scales, f, logsum, ulast);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// B2 over `lanes` sweeps.  Inputs r0 = df * w [lanes, S], M, ustack,
// scales; outputs dM [lanes, n, S, S], du0 [lanes, S].
int tneq_chain_sweep_bwd(int device, const float* r0, const float* M,
                         const float* ustack, const float* scales, int lanes,
                         int n, int S, int cluster, int strip, int stages,
                         int tile_rows, size_t smem, float* dM, float* du0,
                         void* stream) {
  if (!plan_ok(lanes, n, S, cluster, strip, stages, tile_rows, smem,
               bwd_smem_floats(S, strip, stages, tile_rows)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ClusterLaunch l(cluster, lanes, smem, static_cast<cudaStream_t>(stream));
  if (S % 4 == 0 && aligned16(M) && aligned16(dM)) {
    auto* k = sweep_bwd_kernel<true>;
    if ((err = prepare(k, smem, cluster)) != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&l.cfg, k, r0, M, ustack, scales, n, S, strip,
                             stages, tile_rows, dM, du0);
  } else {
    auto* k = sweep_bwd_kernel<false>;
    if ((err = prepare(k, smem, cluster)) != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&l.cfg, k, r0, M, ustack, scales, n, S, strip,
                             stages, tile_rows, dM, du0);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"

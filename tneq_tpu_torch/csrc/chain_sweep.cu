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
// (negligible).  B2 reads M and writes dM (15.2 MB, 4.5 us).  Both are in
// fact bound by their n dependent steps: site i+1 needs all of site i's
// rescaled carry, whose scale is a max over the whole vector.
//
// Design (first, simple version).  The TPU ran the sites as a sequential
// grid with the carry in VMEM scratch, padded to 8 sublanes, S % 128 == 0.
// Hopper blocks run in no fixed order, so the loop over sites lives inside
// ONE block of 1024 threads; no padding, any 1 <= S <= 1024, ragged edges
// masked by the loop bounds.
//   B1: the carry v sits in shared memory.  Thread (g, q) sums rows
//       a = g, g+G, ... of column vector q (VEC = 4 consecutive columns as a
//       float4 when S % 4 == 0), so a warp reads consecutive columns of one
//       row: coalesced.  The G row-group partials meet in shared memory, a
//       block-wide max (warp shuffles) gives s_i, and every thread rescales
//       its columns.  One M_i (256 KiB at S=256) exceeds a block's shared
//       memory, so M streams from device memory / L2 and is never staged.
//   B2: rows of M_i are dotted with draw_i, a warp per row with a shuffle
//       reduction, the draws kept as [n, S]; dM = outer(u_{i-1}, draw_i) is
//       fully parallel and runs as a second, grid-wide launch.
// Later work: a thread-block cluster with a DSMEM max-reduction to spread
// each site over several SMs, the three sweeps of a step in one launch,
// and CUDA graphs around the step.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns
// cudaGetLastError() after its launches (0 = success); it launches on the
// caller's stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxS = 1024;
constexpr float kTiny = 1e-30f;

// max that propagates NaN, like jnp.max / torch.max
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int VEC>
__device__ __forceinline__ void load_cols(const float* p, float (&out)[VEC]);

template <>
__device__ __forceinline__ void load_cols<1>(const float* p, float (&out)[1]) {
  out[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_cols<4>(const float* p, float (&out)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}

// Block-wide max (kMax) or sum of x; every thread gets the result.
// red holds 33 floats.  blockDim.x is a multiple of 32.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? nan_max(x, y) : x + y;
  }
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < nwarps ? red[lane] : 0.f;  // 0 is neutral: max of |.| or sum
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = kMax ? nan_max(x, y) : x + y;
    }
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();  // red may be reused right after
  return r;
}

// B1: forward sweep.  Dynamic shared memory: (S + G*S) floats.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
sweep_fwd_kernel(const float* __restrict__ u0, const float* __restrict__ M,
                 const float* __restrict__ w, int n, int S,
                 float* __restrict__ ustack, float* __restrict__ scales,
                 float* __restrict__ f_out, float* __restrict__ logsum_out,
                 float* __restrict__ ulast) {
  extern __shared__ float smem[];
  __shared__ float red[33];
  float* v = smem;         // [S]    carry u_{i-1}
  float* part = smem + S;  // [G, S] row-group partial sums; row 0 then raw
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int Q = S / VEC;  // column vectors (VEC divides S)
  const int G = nt / Q;   // row groups, >= 1 since Q <= S <= nt
  const int q = tid % Q;
  const int g = tid / Q;

  for (int j = tid; j < S; j += nt) v[j] = u0[j];
  __syncthreads();

  float logsum = 0.f;  // meaningful in thread 0
  for (int i = 0; i < n; ++i) {
    const float* Mi = M + (size_t)i * S * S;
    for (int j = tid; j < S; j += nt) ustack[(size_t)i * S + j] = v[j];
    if (g < G) {
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      const float* col = Mi + q * VEC;
#pragma unroll 4
      for (int a = g; a < S; a += G) {
        float m[VEC];
        load_cols<VEC>(col + (size_t)a * S, m);
        const float va = v[a];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = fmaf(va, m[k], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) part[g * S + q * VEC + k] = acc[k];
    }
    __syncthreads();
    float local = 0.f;
    for (int j = tid; j < S; j += nt) {
      float r = 0.f;
      for (int gg = 0; gg < G; ++gg) r += part[gg * S + j];
      part[j] = r;  // only this thread touches column j
      local = nan_max(local, fabsf(r));
    }
    const float s = block_reduce<true>(local, red) + kTiny;
    for (int j = tid; j < S; j += nt) v[j] = part[j] / s;
    if (tid == 0) {
      scales[i] = s;
      logsum += logf(s);
    }
    __syncthreads();
  }

  float local = 0.f;
  for (int j = tid; j < S; j += nt) {
    ulast[j] = v[j];
    local += v[j] * w[j];
  }
  const float f = block_reduce<false>(local, red);
  if (tid == 0) {
    *f_out = f;
    *logsum_out = logsum;
  }
}

// B2, part 1: reverse sweep for r; stores draw_i = r_i / s_i as [n, S].
template <int VEC>
__global__ void __launch_bounds__(kThreads)
sweep_bwd_kernel(const float* __restrict__ r0, const float* __restrict__ M,
                 const float* __restrict__ scales, int n, int S,
                 float* __restrict__ draws, float* __restrict__ du0) {
  extern __shared__ float smem[];
  float* r = smem;      // [S] cotangent of the carry
  float* d = smem + S;  // [S] draw_i
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  for (int j = tid; j < S; j += nt) r[j] = r0[j];
  __syncthreads();

  for (int i = n - 1; i >= 0; --i) {
    const float s = scales[i];
    for (int j = tid; j < S; j += nt) {
      const float x = r[j] / s;
      d[j] = x;
      draws[(size_t)i * S + j] = x;
    }
    __syncthreads();
    const float* Mi = M + (size_t)i * S * S;
    for (int a = warp; a < S; a += nwarps) {
      const float* row = Mi + (size_t)a * S;
      float acc = 0.f;
      for (int b = lane * VEC; b < S; b += 32 * VEC) {
        float m[VEC];
        load_cols<VEC>(row + b, m);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc = fmaf(m[k], d[b + k], acc);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) r[a] = acc;
    }
    __syncthreads();
  }
  for (int j = tid; j < S; j += nt) du0[j] = r[j];
}

// B2, part 2: dM[i, a, b] = ustack[i, a] * draws[i, b], grid-stride.
template <int VEC>
__global__ void sweep_outer_kernel(const float* __restrict__ ustack,
                                   const float* __restrict__ draws, int n,
                                   int S, float* __restrict__ dM) {
  const size_t SS = (size_t)S * S;
  const size_t total = (size_t)n * SS / VEC;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const size_t flat = e * VEC;
    const size_t i = flat / SS;
    const size_t rem = flat - i * SS;
    const size_t a = rem / S;
    const size_t b = rem - a * S;  // b .. b+VEC-1 lie in row a (VEC | S)
    const float ua = ustack[i * S + a];
    const float* dr = draws + i * S + b;
    if constexpr (VEC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(dr);
      *reinterpret_cast<float4*>(dM + flat) =
          make_float4(ua * t.x, ua * t.y, ua * t.z, ua * t.w);
    } else {
      dM[flat] = ua * dr[0];
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// B1.  Outputs: ustack [n, S], scales [n], f [], logsum [], ulast [S].
int tneq_chain_sweep_fwd(int device, const float* u0, const float* M,
                         const float* w, int n, int S, float* ustack,
                         float* scales, float* f, float* logsum, float* ulast,
                         void* stream) {
  if (n < 1 || S < 1 || S > kMaxS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S % 4 == 0 && aligned16(M)) {
    const int G = kThreads / (S / 4);
    const size_t smem = (size_t)(S + G * S) * sizeof(float);
    sweep_fwd_kernel<4><<<1, kThreads, smem, st>>>(
        u0, M, w, n, S, ustack, scales, f, logsum, ulast);
  } else {
    const int G = kThreads / S;
    const size_t smem = (size_t)(S + G * S) * sizeof(float);
    sweep_fwd_kernel<1><<<1, kThreads, smem, st>>>(
        u0, M, w, n, S, ustack, scales, f, logsum, ulast);
  }
  return (int)cudaGetLastError();
}

// B2.  Inputs r0 = df * w [S], M, ustack, scales; scratch draws [n, S];
// outputs dM [n, S, S], du0 [S].
int tneq_chain_sweep_bwd(int device, const float* r0, const float* M,
                         const float* ustack, const float* scales, int n,
                         int S, float* draws, float* dM, float* du0,
                         void* stream) {
  if (n < 1 || S < 1 || S > kMaxS) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = S % 4 == 0 && aligned16(M) && aligned16(draws) &&
                    aligned16(dM);
  const size_t smem = (size_t)2 * S * sizeof(float);
  if (vec4) {
    sweep_bwd_kernel<4><<<1, kThreads, smem, st>>>(r0, M, scales, n, S,
                                                   draws, du0);
  } else {
    sweep_bwd_kernel<1><<<1, kThreads, smem, st>>>(r0, M, scales, n, S,
                                                   draws, du0);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const size_t work = (size_t)n * S * S / (vec4 ? 4 : 1);
  size_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (vec4) {
    sweep_outer_kernel<4><<<(unsigned)blocks, threads, 0, st>>>(ustack, draws,
                                                               n, S, dM);
  } else {
    sweep_outer_kernel<1><<<(unsigned)blocks, threads, 0, st>>>(ustack, draws,
                                                               n, S, dM);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

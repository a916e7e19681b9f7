// Hand-written Hopper (sm_90a) kernels for the MPS transfer step of the
// Born-rule sweep.
//
// Replaces the two Pallas kernels of tneq_tpu/ops/pallas_kernels.py:
//   B3  fused_transfer_step          (pl.pallas_call at pallas_kernels.py:91)
//   B4  fused_transfer_step_complex  (pl.pallas_call at pallas_kernels.py:177)
// Their VJPs (pallas_kernels.py:231-262) run d_env through these same
// kernels on the transposed core; d_a and d_mx stay torch.einsum reductions
// (ops/transfer_step.py), as JAX left them to XLA.
//
// One step, for env [B, Da, Da], a [Da, K, Dc], mx [B, K, K]:
//     out[z,c,d] = sum_{a,b,k,l} env[z,a,b] * A[a,k,c] * bra(A)[b,l,d] * Mx[z,k,l]
// with bra(A) = A for B3 (float32) and conj(A) for B4 (complex64).
//
// Design.  The TPU forms the [D^2 K^2, B] outer product E = env (x) Mx and
// runs ONE MXU matmul W[cd, abkl] @ E per 512-lane block (2 B D^4 K^2
// flops).  Here the step is factorised, 2 B (2 D^3 K + D^2 K^2) flops
// (13x fewer at D = 8, K = 4):
//     T1[z,b,k,c] = sum_a   env[z,a,b] A[a,k,c]
//     T2[z,b,l,c] = sum_k   T1[z,b,k,c] Mx[z,k,l]
//     out[z,c,d]  = sum_b,l T2[z,b,l,c] bra(A)[b,l,d]
// One block of 256 threads takes a group of zb batch entries.  A is loaded
// once per block into shared memory; env[z] and Mx[z] of the group are
// staged there too (contiguous, coalesced loads), and T1/T2 live in shared
// memory.  Each phase gives a thread one output element, the fastest index
// on neighbouring threads, so shared reads are conflict-free or broadcast
// and the z-major stores of out are coalesced.  Where one z's T1/T2 would
// outgrow shared memory, the block walks over strips of ct columns c (the
// plan, zb and ct, is computed by the Python wrapper).  B4 uses native
// complex FMAs on float2, not the TPU's stacked real form.
//
// What bounds it on an H100.  At the slice width (B = 512, D = 8, K = 4,
// f32) the step reads and writes ~296 KB and does 5.2 MFLOP: 0.09 us by
// bytes.  Every launch at that width is bound by launch latency, not by
// the card.  Later work: mma.sync / wgmma over the batch dimension, and one
// launch for all the transfer steps of a sweep.
//
// Interface: plain C, loaded with ctypes.  Each entry point returns
// cudaGetLastError() after its launch (0 = success); it launches on the
// caller's stream, does not synchronise and allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr size_t kDefaultSmem = 48 * 1024;

struct Real {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  // c + x * y
  static __device__ __forceinline__ T fma(T x, T y, T c) { return fmaf(x, y, c); }
  static __device__ __forceinline__ T bra(T x) { return x; }
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
  static __device__ __forceinline__ T bra(T x) { return make_float2(x.x, -x.y); }
};

template <class Ops>
__global__ void __launch_bounds__(kThreads)
transfer_step_kernel(const typename Ops::T* __restrict__ env,
                     const typename Ops::T* __restrict__ a,
                     const typename Ops::T* __restrict__ mx, int B, int Da,
                     int K, int Dc, int zb, int ct,
                     typename Ops::T* __restrict__ out) {
  using T = typename Ops::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DK = Da * K;
  T* sA = reinterpret_cast<T*>(smem_raw);  // [Da, K, Dc]
  T* sEnv = sA + DK * Dc;                  // [zb, Da, Da]
  T* sMx = sEnv + zb * Da * Da;            // [zb, K, K]
  T* sT1 = sMx + zb * K * K;               // [zb, Da, K, ct]
  T* sT2 = sT1 + zb * DK * ct;             // [zb, Da, K, ct]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int z0 = blockIdx.x * zb;
  const int nz = min(zb, B - z0);

  for (int i = tid; i < DK * Dc; i += nt) sA[i] = a[i];
  const T* envz = env + (size_t)z0 * Da * Da;
  for (int i = tid; i < nz * Da * Da; i += nt) sEnv[i] = envz[i];
  const T* mxz = mx + (size_t)z0 * K * K;
  for (int i = tid; i < nz * K * K; i += nt) sMx[i] = mxz[i];
  __syncthreads();

  for (int c0 = 0; c0 < Dc; c0 += ct) {
    const int w = min(ct, Dc - c0);
    const int n1 = nz * DK * w;
    // T1[zz,b,k,j] = sum_a env[zz,a,b] A[a,k,c0+j]
    for (int i = tid; i < n1; i += nt) {
      const int j = i % w;
      const int bk = (i / w) % DK;  // b * K + k
      const int zz = i / (w * DK);
      const int b = bk / K;
      const int k = bk - b * K;
      const T* e = sEnv + zz * Da * Da + b;
      const T* ap = sA + k * Dc + c0 + j;
      T acc = Ops::zero();
      for (int aa = 0; aa < Da; ++aa)
        acc = Ops::fma(e[aa * Da], ap[aa * K * Dc], acc);
      sT1[(zz * DK + bk) * ct + j] = acc;
    }
    __syncthreads();
    // T2[zz,b,l,j] = sum_k T1[zz,b,k,j] Mx[zz,k,l]
    for (int i = tid; i < n1; i += nt) {
      const int j = i % w;
      const int bl = (i / w) % DK;  // b * K + l
      const int zz = i / (w * DK);
      const int b = bl / K;
      const int l = bl - b * K;
      const T* t1 = sT1 + (zz * DK + b * K) * ct + j;
      const T* m = sMx + zz * K * K + l;
      T acc = Ops::zero();
      for (int k = 0; k < K; ++k) acc = Ops::fma(t1[k * ct], m[k * K], acc);
      sT2[(zz * DK + bl) * ct + j] = acc;
    }
    __syncthreads();
    // out[zz,c0+j,d] = sum_{b,l} T2[zz,b,l,j] bra(A)[b,l,d]
    const int n2 = nz * w * Dc;
    for (int i = tid; i < n2; i += nt) {
      const int d = i % Dc;
      const int j = (i / Dc) % w;
      const int zz = i / (Dc * w);
      const T* t2 = sT2 + zz * DK * ct + j;
      const T* ap = sA + d;
      T acc = Ops::zero();
      for (int bl = 0; bl < DK; ++bl)
        acc = Ops::fma(t2[bl * ct], Ops::bra(ap[bl * Dc]), acc);
      out[((size_t)(z0 + zz) * Dc + c0 + j) * Dc + d] = acc;
    }
    __syncthreads();  // the next strip overwrites T1 and T2
  }
}

template <class Ops>
int launch(int device, const void* env, const void* a, const void* mx, int B,
           int Da, int K, int Dc, int zb, int ct, void* out, void* stream) {
  using T = typename Ops::T;
  if (B < 1 || Da < 1 || K < 1 || Dc < 1 || zb < 1 || ct < 1 || ct > Dc)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * ((size_t)Da * K * Dc +
                   (size_t)zb * ((size_t)Da * Da + (size_t)K * K +
                                 2 * (size_t)Da * K * ct));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(transfer_step_kernel<Ops>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((B + zb - 1) / zb);
  transfer_step_kernel<Ops><<<blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(env), static_cast<const T*>(a),
      static_cast<const T*>(mx), B, Da, K, Dc, zb, ct, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B3 (float32).  env [B, Da, Da], a [Da, K, Dc], mx [B, K, K] -> out [B, Dc, Dc].
int tneq_transfer_step_f32(int device, const void* env, const void* a,
                           const void* mx, int B, int Da, int K, int Dc,
                           int zb, int ct, void* out, void* stream) {
  return launch<Real>(device, env, a, mx, B, Da, K, Dc, zb, ct, out, stream);
}

// B4 (complex64, interleaved re/im as float2; the bra is conj(A)).
int tneq_transfer_step_c64(int device, const void* env, const void* a,
                           const void* mx, int B, int Da, int K, int Dc,
                           int zb, int ct, void* out, void* stream) {
  return launch<Complex>(device, env, a, mx, B, Da, K, Dc, zb, ct, out,
                         stream);
}

}  // extern "C"

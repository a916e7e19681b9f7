// Hand-written Hopper (sm_90a) kernels for the row sweep's gate steps.
//
// Replaces no pl.pallas_call: the JAX package runs these steps as XLA dot
// products inside its row scan (tneq_tpu/ops/row_scan.py).  They were added
// because, in PyTorch, a gate step is a torch.einsum whose backward reduces
// d_gate over the whole environment as a batched GEMM with M, N <= 16 and
// K = 65536: cuBLAS runs each as one 32 x 32 output tile per lane, a grid of
// a few CTAs on a 132-SM card (~2.7 ms each, ~270x the bytes' time;
// PERF.md section 5).
//
// A gate step contracts K legs of a large environment E with one small gate
// G and writes the gate's N new legs (ops/row_scan.py, GateForm):
//     O[l, f, n] = sum_d sum_k G'[l, k, n] * E[l, f, d, k]
// with G' = conj(G) when the conj flag is set (the bra's cores), f the free
// legs of E, k the contracted ones, n the gate's new legs and d an optional
// diagonal of E (one leg that appears twice in E and nowhere else, summed).
// The backward (the VJP, PyTorch's convention for complex gradients):
//     dE[l, f, a, a', k] = [a == a'] * sum_n dO[l, f, n] * conj(G'[l, k, n])
//     dG'[l, k, n]       = sum_f sum_d conj(E[l, f, d, k]) * dO[l, f, n]
// and dG = conj(dG') when the flag is set.  Every tensor is read and written
// through its strides (a descriptor built by the Python wrapper, legs of
// size 1 dropped, adjacent legs merged where every tensor allows): the
// environment is never copied, the gate may be expanded (lane stride 0),
// and O, dE, dG are written once in their logical layout.
//
// What bounds them on an H100.  Per gate step of the 8 x 5 brick wall at 8
// lanes (complex64, E 2^18 entries a lane, K = N = 4): the forward reads E
// and writes O (33.5 MB, 10 us at 3.35 TB/s) and does 8 * 2^18 * 16 complex
// FMAs (0.27 GFLOP: 4 us at 67 TFLOP/s); the backward reads E and dO and
// writes dE (50 MB, 15 us).  Memory-bound, in plain FP32 FMAs on the CUDA
// cores (complex as (re, im) pairs; no tensor cores, no TF32).
//
// Design.  Each CTA of 256 threads takes tiles of `tile` free positions of
// one lane (grid: blocks x lanes, enough CTAs to fill the card at 8 lanes
// and at 1).  A tile's offsets are decomposed once into shared memory; the
// environment's K values per position (summed over the diagonal) and, in
// the backward, dO's N values are staged in shared memory with consecutive
// threads on the operand's innermost axis, so every global load and store
// is coalesced whether k (or n) or f is innermost.  The gate, conjugated as
// the flag asks, sits in shared memory.
//   d_gate.  Each thread owns one (k, n) pair of one of 256 / (K*N) groups
//       and sums conj(E) * dO over its group's share of every tile, in a
//       fixed order; the groups are added in order into the CTA's partial
//       K*N sums, written to a scratch [lanes, blocks, K*N].  The last CTA
//       to finish (a counter, reset by that CTA for the next launch) adds
//       the partials in block order, one warp per output with a fixed
//       shuffle tree: no float atomics, so two runs give the same bits.

#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kMaxFree = 24;  // free dims after merging (FREE_DIMS in ops/row_scan.py)
constexpr int kMaxLegs = 8;   // k legs and n legs of sizes >= 2: K*N <= 256

// Mirrors ops/row_scan.py::_Desc (ctypes); strides and offsets in elements.
// Outside the anonymous namespace: the C entry points take it.
struct RowGateDesc {
  long long lane_e, lane_g, lane_o, lane_do, lane_de, lane_dg;
  int lanes, F, K, N, D, conj, tile, blocks;
  int k_fast_e, n_fast_o, n_fast_do, k_fast_de;
  int d_e, d_de1, d_de2;
  int nf, nk, nn;
  int f_size[kMaxFree], f_e[kMaxFree], f_o[kMaxFree], f_do[kMaxFree], f_de[kMaxFree];
  int k_size[kMaxLegs], k_e[kMaxLegs], k_g[kMaxLegs], k_de[kMaxLegs], k_dg[kMaxLegs];
  int n_size[kMaxLegs], n_g[kMaxLegs], n_o[kMaxLegs], n_do[kMaxLegs], n_dg[kMaxLegs];
};

namespace {

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float2 zero_of(float2) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ float conj_of(float a) { return a; }
__device__ __forceinline__ float2 conj_of(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
// c + a * b
__device__ __forceinline__ float fma_of(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ float2 fma_of(float2 a, float2 b, float2 c) {
  return make_float2(fmaf(-a.y, b.y, fmaf(a.x, b.x, c.x)), fmaf(a.y, b.x, fmaf(a.x, b.y, c.y)));
}
__device__ __forceinline__ float shfl_xor(float v, int m) { return __shfl_xor_sync(0xffffffffu, v, m); }
__device__ __forceinline__ float2 shfl_xor(float2 v, int m) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, m), __shfl_xor_sync(0xffffffffu, v.y, m));
}

// Offset of a mixed-radix index over `n` legs (the last leg innermost).
__device__ __forceinline__ int leg_offset(int idx, int n, const int* size, const int* stride) {
  int off = 0;
  for (int i = n - 1; i >= 0; --i) {
    const int q = idx / size[i];
    off += (idx - q * size[i]) * stride[i];
    idx = q;
  }
  return off;
}

// Item i of an (nt positions) x (m values) loop: the value index innermost
// when `fast` (it is the operand's innermost axis), else the position.
__device__ __forceinline__ void split(int i, int nt, int m, int fast, int& f, int& v) {
  if (fast) {
    f = i / m;
    v = i - f * m;
  } else {
    v = i / nt;
    f = i - v * nt;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_gate_fwd_kernel(const __grid_constant__ RowGateDesc d, const T* __restrict__ E, const T* __restrict__ G,
                    T* __restrict__ O) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = d.K, N = d.N, tile = d.tile, ld = tile + 1, tid = threadIdx.x;
  T* sG = reinterpret_cast<T*>(smem);   // [K][N], conjugated as the flag asks
  T* sE = sG + K * N;                   // [K][ld]: E summed over the diagonal
  int* sOffE = reinterpret_cast<int*>(sE + K * ld);
  int* sOffO = sOffE + tile;
  int* sKE = sOffO + tile;
  int* sNO = sKE + K;
  const long long lane = blockIdx.y;
  E += lane * d.lane_e;
  G += lane * d.lane_g;
  O += lane * d.lane_o;
  for (int i = tid; i < K * N; i += kThreads) {
    const int k = i / N, n = i - k * N;
    const T g = G[leg_offset(k, d.nk, d.k_size, d.k_g) + leg_offset(n, d.nn, d.n_size, d.n_g)];
    sG[i] = d.conj ? conj_of(g) : g;
  }
  for (int k = tid; k < K; k += kThreads) sKE[k] = leg_offset(k, d.nk, d.k_size, d.k_e);
  for (int n = tid; n < N; n += kThreads) sNO[n] = leg_offset(n, d.nn, d.n_size, d.n_o);
  const int ntiles = (d.F + tile - 1) / tile;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int f0 = t * tile, nt = min(tile, d.F - f0);
    __syncthreads();  // the last tile's readers are done; the tables are written
    for (int i = tid; i < nt; i += kThreads) {
      int idx = f0 + i, oe = 0, oo = 0;
      for (int j = d.nf - 1; j >= 0; --j) {
        const int q = idx / d.f_size[j], r = idx - q * d.f_size[j];
        oe += r * d.f_e[j];
        oo += r * d.f_o[j];
        idx = q;
      }
      sOffE[i] = oe;
      sOffO[i] = oo;
    }
    __syncthreads();
    for (int i = tid; i < nt * K; i += kThreads) {
      int f, k;
      split(i, nt, K, d.k_fast_e, f, k);
      const T* p = E + sOffE[f] + sKE[k];
      T v = p[0];
      for (int a = 1; a < d.D; ++a) v = add(v, p[a * d.d_e]);
      sE[k * ld + f] = v;
    }
    __syncthreads();
    for (int i = tid; i < nt * N; i += kThreads) {
      int f, n;
      split(i, nt, N, d.n_fast_o, f, n);
      T acc = zero_of(T());
      for (int k = 0; k < K; ++k) acc = fma_of(sG[k * N + n], sE[k * ld + f], acc);
      O[sOffO[f] + sNO[n]] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_gate_bwd_kernel(const __grid_constant__ RowGateDesc d, const T* __restrict__ E, const T* __restrict__ G,
                    const T* __restrict__ dO, T* __restrict__ dE, T* __restrict__ dG,
                    T* __restrict__ partial, unsigned int* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[kThreads];
  __shared__ bool last;
  const int K = d.K, N = d.N, P = K * N, tile = d.tile, ld = tile + 1, tid = threadIdx.x;
  const bool want_e = dE != nullptr, want_g = dG != nullptr;
  T* sGc = reinterpret_cast<T*>(smem);  // [K][N]: conj(G'), the factor of dE
  T* sD = sGc + P;                      // [N][ld]: dO
  T* sE = sD + N * ld;                  // [K][ld]: conj(E) summed over the diagonal
  int* sOffE = reinterpret_cast<int*>(sE + K * ld);
  int* sOffDO = sOffE + tile;
  int* sOffDE = sOffDO + tile;
  int* sKE = sOffDE + tile;
  int* sKDE = sKE + K;
  int* sNDO = sKDE + K;
  const long long lane = blockIdx.y;
  E += lane * d.lane_e;
  G += lane * d.lane_g;
  dO += lane * d.lane_do;
  if (want_e) dE += lane * d.lane_de;
  for (int i = tid; i < P; i += kThreads) {
    const int k = i / N, n = i - k * N;
    const T g = G[leg_offset(k, d.nk, d.k_size, d.k_g) + leg_offset(n, d.nn, d.n_size, d.n_g)];
    sGc[i] = d.conj ? g : conj_of(g);
  }
  for (int k = tid; k < K; k += kThreads) {
    sKE[k] = leg_offset(k, d.nk, d.k_size, d.k_e);
    sKDE[k] = leg_offset(k, d.nk, d.k_size, d.k_de);
  }
  for (int n = tid; n < N; n += kThreads) sNDO[n] = leg_offset(n, d.nn, d.n_size, d.n_do);
  // this thread's (k, n) pair of d_gate and its group
  const int groups = kThreads / P, grp = tid / P, pk = (tid - grp * P) / N,
            pn = tid - grp * P - pk * N;
  T acc = zero_of(T());
  const int ntiles = (d.F + tile - 1) / tile;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int f0 = t * tile, nt = min(tile, d.F - f0);
    __syncthreads();
    for (int i = tid; i < nt; i += kThreads) {
      int idx = f0 + i, oe = 0, odo = 0, ode = 0;
      for (int j = d.nf - 1; j >= 0; --j) {
        const int q = idx / d.f_size[j], r = idx - q * d.f_size[j];
        oe += r * d.f_e[j];
        odo += r * d.f_do[j];
        ode += r * d.f_de[j];
        idx = q;
      }
      sOffE[i] = oe;
      sOffDO[i] = odo;
      sOffDE[i] = ode;
    }
    __syncthreads();
    for (int i = tid; i < nt * N; i += kThreads) {
      int f, n;
      split(i, nt, N, d.n_fast_do, f, n);
      sD[n * ld + f] = dO[sOffDO[f] + sNDO[n]];
    }
    if (want_g) {
      for (int i = tid; i < nt * K; i += kThreads) {
        int f, k;
        split(i, nt, K, d.k_fast_e, f, k);
        const T* p = E + sOffE[f] + sKE[k];
        T v = p[0];
        for (int a = 1; a < d.D; ++a) v = add(v, p[a * d.d_e]);
        sE[k * ld + f] = conj_of(v);
      }
    }
    __syncthreads();
    if (want_e) {
      for (int i = tid; i < nt * K; i += kThreads) {
        int f, k;
        split(i, nt, K, d.k_fast_de, f, k);
        T v = zero_of(T());
        for (int n = 0; n < N; ++n) v = fma_of(sD[n * ld + f], sGc[k * N + n], v);
        T* q = dE + sOffDE[f] + sKDE[k];
        if (d.D == 1) {
          q[0] = v;
        } else {
          for (int a = 0; a < d.D; ++a)
            for (int b = 0; b < d.D; ++b) q[a * d.d_de1 + b * d.d_de2] = a == b ? v : zero_of(T());
        }
      }
    }
    if (want_g && grp < groups) {
      for (int f = grp; f < nt; f += groups) acc = fma_of(sE[pk * ld + f], sD[pn * ld + f], acc);
    }
  }
  if (!want_g) return;
  red[tid] = acc;
  __syncthreads();
  if (tid < P) {
    T s = red[tid];
    for (int g = 1; g < groups; ++g) s = add(s, red[g * P + tid]);
    partial[(lane * gridDim.x + blockIdx.x) * P + tid] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = tid / 32, wl = tid % 32, nb = gridDim.x;
  for (int o = warp; o < d.lanes * P; o += kThreads / 32) {
    const int l = o / P, p = o - l * P;
    const T* src = partial + (long long)l * nb * P + p;
    T s = zero_of(T());
    for (int b = wl; b < nb; b += 32) s = add(s, __ldcg(src + (long long)b * P));
    for (int m = 16; m > 0; m >>= 1) s = add(s, shfl_xor(s, m));
    if (wl == 0) {
      const int k = p / N, n = p - k * N;
      dG[l * d.lane_dg + leg_offset(k, d.nk, d.k_size, d.k_dg) +
         leg_offset(n, d.nn, d.n_size, d.n_dg)] = d.conj ? conj_of(s) : s;
    }
  }
  if (tid == 0) *counter = 0u;  // ready for the next launch on this stream
}

template <typename T>
size_t fwd_smem(const RowGateDesc& d) {
  return sizeof(T) * (size_t)(d.K * d.N + d.K * (d.tile + 1)) +
         sizeof(int) * (size_t)(2 * d.tile + d.K + d.N);
}

template <typename T>
size_t bwd_smem(const RowGateDesc& d) {
  return sizeof(T) * (size_t)(d.K * d.N + (d.K + d.N) * (d.tile + 1)) +
         sizeof(int) * (size_t)(3 * d.tile + 2 * d.K + d.N);
}

// Shared memory above the default 48 KB needs the kernel's opt-in.
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fwd(const RowGateDesc& d, const void* E, const void* G, void* O, cudaStream_t s) {
  const size_t smem = fwd_smem<T>(d);
  cudaError_t err = allow_smem((const void*)row_gate_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  row_gate_fwd_kernel<T><<<dim3(d.blocks, d.lanes), kThreads, smem, s>>>(
      d, static_cast<const T*>(E), static_cast<const T*>(G), static_cast<T*>(O));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const RowGateDesc& d, const void* E, const void* G, const void* dO, void* dE,
               void* dG, void* partial, unsigned int* counter, cudaStream_t s) {
  const size_t smem = bwd_smem<T>(d);
  cudaError_t err = allow_smem((const void*)row_gate_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  row_gate_bwd_kernel<T><<<dim3(d.blocks, d.lanes), kThreads, smem, s>>>(
      d, static_cast<const T*>(E), static_cast<const T*>(G), static_cast<const T*>(dO),
      static_cast<T*>(dE), static_cast<T*>(dG), static_cast<T*>(partial), counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The size of the descriptor, checked by the wrapper against its ctypes copy.
int tneq_row_gate_desc_size() { return (int)sizeof(RowGateDesc); }

// One gate step's forward over d->lanes lanes: O = sum G' E.  `is_complex`:
// complex64 (float2) tensors, else float32.  Returns the CUDA error code.
int tneq_row_gate_fwd(int device, const RowGateDesc* d, int is_complex, const void* E,
                      const void* G, void* O, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_complex ? launch_fwd<float2>(*d, E, G, O, s) : launch_fwd<float>(*d, E, G, O, s);
}

// Its backward in one launch: dE (when not null) and dG (when not null,
// with `partial` [lanes * blocks * K * N] of scratch and `counter`, one
// zeroed unsigned int that the launch leaves zeroed).
int tneq_row_gate_bwd(int device, const RowGateDesc* d, int is_complex, const void* E,
                      const void* G, const void* dO, void* dE, void* dG, void* partial,
                      unsigned int* counter, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_complex ? launch_bwd<float2>(*d, E, G, dO, dE, dG, partial, counter, s)
                    : launch_bwd<float>(*d, E, G, dO, dE, dG, partial, counter, s);
}

}  // extern "C"

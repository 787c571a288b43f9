// eMA: out[b, j, v] = sum_l m_a[b, IA[j, l], v] * y_p[b, IP[j, l], v].
//
// Replaces the TPU kernel ema_pallas (src/repro/kernels/ema/pallas_ema.py,
// _kernel and ema_pallas), which kept both child tables resident in VMEM
// per vertex block and gathered rows with dynamic sublane indexing.
//
// Here threads run along v, so every row gather is a coalesced load, and a
// CUDA block takes EMA_ROWS output rows of one colouring, with their IA/IP
// entries staged in shared memory. Sums are f32 for f32 and bf16 storage.
// The kernel writes exactly the (B, S, n) output: rows past S and columns
// past n are never touched, so there are no padded rows to zero.
//
// What bounds it on the H100: device-memory bytes. Each output element
// does L multiply-adds on 2L gathered inputs; the design reads those rows
// contiguously and leans on the 50 MB L2 for the reuse of a row across the
// output rows that select it.
#include "bsr_tile.cuh"

namespace {

constexpr int EMA_THREADS = 256;
constexpr int EMA_ROWS = 8;  // output rows per CUDA block

template <typename T>
__global__ void __launch_bounds__(EMA_THREADS)
    ema_kernel(const T* __restrict__ m_a, const T* __restrict__ y_p,
               const int* __restrict__ ia, const int* __restrict__ ip, int s,
               int l, int c_a, int c_p, long long n, T* __restrict__ out) {
  extern __shared__ int idx_s[];  // IA rows, then IP rows of this block
  const int j0 = blockIdx.y * EMA_ROWS;
  const int nj = min(EMA_ROWS, s - j0);
  for (int i = threadIdx.x; i < nj * l; i += EMA_THREADS) {
    idx_s[i] = ia[j0 * l + i];
    idx_s[EMA_ROWS * l + i] = ip[j0 * l + i];
  }
  __syncthreads();
  const long long v = (long long)blockIdx.x * EMA_THREADS + threadIdx.x;
  if (v >= n) return;
  const long long b = blockIdx.z;
  const T* ma = m_a + b * c_a * n + v;
  const T* yp = y_p + b * c_p * n + v;
  T* o = out + (b * s + j0) * n + v;
  for (int j = 0; j < nj; ++j) {
    const int* a_idx = idx_s + j * l;
    const int* p_idx = idx_s + EMA_ROWS * l + j * l;
    float acc = 0.f;
    for (int q = 0; q < l; ++q)
      acc += rt::to_f32(ma[a_idx[q] * n]) * rt::to_f32(yp[p_idx[q] * n]);
    o[j * n] = rt::from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* m_a, const void* y_p, const int* ia, const int* ip,
           int s, int l, int c_a, int c_p, long long n, int batch, void* out,
           cudaStream_t stream) {
  const int smem = 2 * EMA_ROWS * l * (int)sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ema_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((n + EMA_THREADS - 1) / EMA_THREADS),
                  (s + EMA_ROWS - 1) / EMA_ROWS, batch);
  ema_kernel<T><<<grid, EMA_THREADS, smem, stream>>>(
      static_cast<const T*>(m_a), static_cast<const T*>(y_p), ia, ip, s, l,
      c_a, c_p, n, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Tables are contiguous (batch, rows, n).
// Returns the cudaError_t of the launch.
extern "C" int rt_ema(int dtype, const void* m_a, const void* y_p,
                      const int* ia, const int* ip, int s, int l, int c_a,
                      int c_p, long long n, int batch, void* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(m_a, y_p, ia, ip, s, l, c_a, c_p, n, batch, out, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(m_a, y_p, ia, ip, s, l, c_a, c_p, n, batch,
                                 out, st);
  return (int)cudaErrorInvalidValue;
}

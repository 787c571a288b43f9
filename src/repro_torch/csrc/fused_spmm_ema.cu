// Fused SpMM -> eMA: out = ema(m_a, m_p @ A, IA, IP) without writing
// y = m_p @ A to device memory.
//
// Replaces the TPU kernel fused_spmm_ema_pallas (src/repro/kernels/fused/
// pallas_fused.py, _kernel and fused_spmm_ema_pallas), which accumulated y
// in VMEM over a sequential grid axis and applied the split combination as
// one-hot selection matmuls on the MXU, with bb colourings per step.
//
// Here one CUDA block owns (destination tile, TV-column slice, colouring b):
//   1. it starts copying m_a[b, :, slice] into shared memory (cp.async),
//      when those c_a rows fit A_SLICE_BYTES;
//   2. meanwhile it sums y[c_p, TV] in shared memory over the nonzeros of
//      the tile's block run that fall in its slice (the slice walk of
//      bsr_sparse_tile.cuh: each listed source loaded straight into
//      registers, 16 rows a thread side by side);
//   3. it writes out[b, j, v] = sum_l m_a[b, IA[j, l], v] * y[IP[j, l], v]
//      for every j straight to device memory, indexing rows of y and of the
//      m_a slice in shared memory directly (no selection matmuls). A
//      half-warp takes an output row, a lane two adjacent columns; a warp
//      sums R rows of each half side by side.
// The batch is a grid dimension, not a block of colourings per step. Sums
// are f32 for f32 and bf16 storage, in a fixed order (blocks in run order,
// a column's sources ascending; the L terms ascending), without atomics.
//
// What bounds it on the H100: the SpMM leg reads each listed source value
// of every table row once per destination tile that lists it (~3 times on
// a mesh, mostly from L2; a warp's 32 columns share their lines); the eMA
// leg is shared-memory reads, two a term, and the S rows of out written.
// Shared memory: y takes c_p * TV * 4 bytes beside the m_a slice's 32 KB,
// so c_p <= 1,560 fits the 227 KB a block may have (kernels/fused/ops.py
// holds the fit model that admits plan nodes).
#include "bsr_sparse_tile.cuh"

namespace {

// two blocks an SM: ptxas then keeps the leg's R x 4 terms in flight in
// registers (without the bound it held 48 and spilled)
template <typename T, int R, bool STAGE_A>
__global__ void __launch_bounds__(rt::THREADS, 2)
    fused_kernel(const T* __restrict__ m_a, const T* __restrict__ m_p,
                 const int* __restrict__ ia, const int* __restrict__ ip,
                 int s, int l, int c_a, int c_p, long long n,
                 const int* __restrict__ src_tile,
                 const int* __restrict__ tile_ptr,
                 const int* __restrict__ col_ptr,
                 const unsigned char* __restrict__ nz_src,
                 T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* y = reinterpret_cast<float*>(smem);
  T* a_s = reinterpret_cast<T*>(smem + (size_t)c_p * rt::TV * sizeof(float));
  const int tile = blockIdx.x / rt::SLICES;
  const int col0 = (blockIdx.x % rt::SLICES) * rt::TV;
  const long long b = blockIdx.y;
  const long long v0 = (long long)tile * rt::TILE + col0;
  const T* ma = m_a + b * c_a * n;
  if constexpr (STAGE_A) rt::stage_slice(a_s, ma, c_a, n, v0);
  rt::bsr_slice_run_accumulate(m_p + b * c_p * n, n, c_p, src_tile, col_ptr,
                               nz_src, tile_ptr[tile], tile_ptr[tile + 1],
                               col0, y);
  if constexpr (STAGE_A) rt::cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int half = (threadIdx.x >> 4) & 1;
  const int c = 2 * (lane & 15);
  const long long v = v0 + c;
  if (v >= n) return;
  const bool both = v + 1 < n;
  const bool vec = n % 2 == 0;  // v is even: a pair store is aligned
  T* o = out + b * s * n + v;
  const int stride = 2 * rt::WARPS * R;
  for (int j0 = ((threadIdx.x >> 5) * 2 + half) * R; j0 < s; j0 += stride) {
    const int* a_idx[R];
    const int* p_idx[R];
    float2 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = min(j0 + r, s - 1);
      a_idx[r] = ia + j * l;
      p_idx[r] = ip + j * l;
      acc[r] = make_float2(0.f, 0.f);
    }
#pragma unroll 4
    for (int q = 0; q < l; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = a_idx[r][q];
        float2 x;
        if constexpr (STAGE_A) {
          x = rt::pair_at(a_s + a * rt::TV, c);
        } else {
          x.x = rt::to_f32(ma[a * n + v]);
          x.y = both ? rt::to_f32(ma[a * n + v + 1]) : 0.f;
        }
        const float2 z = rt::pair_at(y + p_idx[r][q] * rt::TV, c);
        acc[r].x += x.x * z.x;
        acc[r].y += x.y * z.y;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (j0 + r < s)
        rt::store_pair(o + (long long)(j0 + r) * n, acc[r], both, vec);
  }
}

// R output rows a half-warp sums side by side: 4 where every half-warp has
// several passes of them, else 1, so that a short S spreads over the warps
template <typename T, int R, bool STAGE_A>
int launch_as(const void* m_a, const void* m_p, const int* ia, const int* ip,
              int s, int l, int c_a, int c_p, long long n, int batch,
              const int* src_tile, const int* tile_ptr, const int* col_ptr,
              const unsigned char* nz_src, int n_tiles, void* out,
              cudaStream_t stream) {
  const long long smem = (long long)c_p * rt::TV * sizeof(float) +
                         (STAGE_A ? (long long)c_a * rt::TV * sizeof(T) : 0);
  if (smem > rt::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_kernel<T, R, STAGE_A>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_tiles * rt::SLICES, batch);
  fused_kernel<T, R, STAGE_A><<<grid, rt::THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(m_a), static_cast<const T*>(m_p), ia, ip, s, l,
      c_a, c_p, n, src_tile, tile_ptr, col_ptr, nz_src, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* m_a, const void* m_p, const int* ia, const int* ip,
           int s, int l, int c_a, int c_p, long long n, int batch,
           const int* src_tile, const int* tile_ptr, const int* col_ptr,
           const unsigned char* nz_src, int n_tiles, void* out,
           cudaStream_t stream) {
  const bool stage_a =
      (long long)c_a * rt::TV * sizeof(T) <= rt::A_SLICE_BYTES;
  const bool tall = s >= 4 * 2 * rt::WARPS * 4;
  if (stage_a && tall)
    return launch_as<T, 4, true>(m_a, m_p, ia, ip, s, l, c_a, c_p, n, batch,
                                 src_tile, tile_ptr, col_ptr, nz_src, n_tiles,
                                 out, stream);
  if (stage_a)
    return launch_as<T, 1, true>(m_a, m_p, ia, ip, s, l, c_a, c_p, n, batch,
                                 src_tile, tile_ptr, col_ptr, nz_src, n_tiles,
                                 out, stream);
  if (tall)
    return launch_as<T, 4, false>(m_a, m_p, ia, ip, s, l, c_a, c_p, n, batch,
                                  src_tile, tile_ptr, col_ptr, nz_src,
                                  n_tiles, out, stream);
  return launch_as<T, 1, false>(m_a, m_p, ia, ip, s, l, c_a, c_p, n, batch,
                                src_tile, tile_ptr, col_ptr, nz_src, n_tiles,
                                out, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Tables are contiguous (batch, rows, n).
// Returns the cudaError_t of the launch.
extern "C" int rt_fused_spmm_ema(int dtype, const void* m_a,
                                 const void* m_p, const int* ia,
                                 const int* ip, int s, int l, int c_a,
                                 int c_p, long long n, int batch,
                                 const int* src_tile, const int* tile_ptr,
                                 const int* col_ptr,
                                 const unsigned char* nz_src, int n_tiles,
                                 void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(m_a, m_p, ia, ip, s, l, c_a, c_p, n, batch,
                         src_tile, tile_ptr, col_ptr, nz_src, n_tiles, out,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(m_a, m_p, ia, ip, s, l, c_a, c_p, n, batch,
                                 src_tile, tile_ptr, col_ptr, nz_src, n_tiles,
                                 out, st);
  return (int)cudaErrorInvalidValue;
}

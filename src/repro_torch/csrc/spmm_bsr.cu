// BSR SpMM, Y = M @ A, for a (rows, n) count table M.
//
// Replaces the TPU kernel spmm_bsr_pallas (src/repro/kernels/spmm/
// pallas_bsr.py, _kernel and spmm_bsr_pallas), which walked the
// destination-sorted block stream on a sequential grid axis, multiplied
// each dense 128x128 block on the MXU and kept the partial sums in VMEM
// scratch between steps.
//
// Here one CUDA block owns a whole destination tile and ROWS rows of M
// and walks the tile's block run itself, so the sum needs no atomics and
// has a fixed order. It walks only each block's nonzeros
// (bsr_sparse_tile.cuh): a road-like graph's block holds ~100 of its
// 16,384 entries, and the dense product would be ~150x the useful adds on
// CUDA cores. Sums are f32 for f32 and bf16 storage.
//
// ROWS, the rows of M a CUDA block takes, is the launch shape the
// autotuner chooses (kernels/autotune.py, spmm_c_block): one instantiation
// each of 2, 4, 8, 16, 32 and 64 rows, 32 by default. A block stages ROWS
// rows of each source slice whatever the table holds, so a table of few
// rows (the chunked eMA's one-row SpMMs) wastes most of a 32-row block's
// copies and sums; a narrow block wastes none. Each output is summed in
// the same order at every ROWS, so the shapes agree bit for bit.
//
// What bounds it on the H100: device-memory bytes. Each source slice of M
// is staged once per destination tile (a mesh tile's run has ~5 blocks:
// the tile itself, +-1 and +-8), so M is read ~5 times, mostly from L2
// (neighbouring tiles run together and share their slices), and Y written
// once; the nonzero index adds 4 bytes a column and a byte an edge for
// each row chunk.
#include "bsr_sparse_tile.cuh"

namespace {

template <typename T, int ROWS>
__global__ void __launch_bounds__(rt::SP_THREADS)
    spmm_bsr_kernel(const T* __restrict__ m, int rows, long long n,
                    const int* __restrict__ src_tile,
                    const int* __restrict__ tile_ptr,
                    const int* __restrict__ col_ptr,
                    const unsigned char* __restrict__ nz_src,
                    T* __restrict__ out) {
  constexpr int RPT = ROWS / rt::SP_COL_THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x;
  const int r0 = blockIdx.y * ROWS;
  const int nr = min(ROWS, rows - r0);
  float acc[RPT];
  rt::bsr_sparse_run_accumulate<T, ROWS>(
      m + (long long)r0 * n, n, nr, src_tile, col_ptr, nz_src, tile_ptr[tile],
      tile_ptr[tile + 1], reinterpret_cast<T*>(smem), acc);
  const long long v = (long long)tile * rt::TILE + threadIdx.x % rt::TILE;
  const int row0 = (threadIdx.x / rt::TILE) * RPT;
  if (v >= n) return;
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (row0 + k < nr)
      out[(long long)(r0 + row0 + k) * n + v] = rt::from_f32<T>(acc[k]);
}

template <typename T, int ROWS>
int launch_rows(const void* m, int rows, long long n, const int* src_tile,
                const int* tile_ptr, const int* col_ptr,
                const unsigned char* nz_src, int n_tiles, void* out,
                cudaStream_t stream) {
  const long long row_blocks = (rows + ROWS - 1) / ROWS;
  if (row_blocks > 65535) return (int)cudaErrorInvalidConfiguration;
  constexpr int smem = rt::sparse_smem_bytes<T, ROWS>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spmm_bsr_kernel<T, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_tiles, (unsigned)row_blocks);
  spmm_bsr_kernel<T, ROWS><<<grid, rt::SP_THREADS, smem, stream>>>(
      static_cast<const T*>(m), rows, n, src_tile, tile_ptr, col_ptr, nz_src,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int rows_per_block, const void* m, int rows, long long n,
           const int* src_tile, const int* tile_ptr, const int* col_ptr,
           const unsigned char* nz_src, int n_tiles, void* out,
           cudaStream_t stream) {
  switch (rows_per_block) {
#define RT_ROWS(R)                                                        \
  case R:                                                                 \
    return launch_rows<T, R>(m, rows, n, src_tile, tile_ptr, col_ptr,     \
                             nz_src, n_tiles, out, stream);
    RT_ROWS(2)
    RT_ROWS(4)
    RT_ROWS(8)
    RT_ROWS(16)
    RT_ROWS(32)
    RT_ROWS(64)
#undef RT_ROWS
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (storage; the sums are f32 either way).
// rows_per_block: 2, 4, 8, 16, 32 or 64 (rt::SP_ROWS = 32 by default).
// Returns the cudaError_t of the launch.
extern "C" int rt_spmm_bsr(int dtype, int rows_per_block, const void* m,
                           int rows, long long n, const int* src_tile,
                           const int* tile_ptr, const int* col_ptr,
                           const unsigned char* nz_src, int n_tiles,
                           void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(rows_per_block, m, rows, n, src_tile, tile_ptr,
                         col_ptr, nz_src, n_tiles, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(rows_per_block, m, rows, n, src_tile,
                                 tile_ptr, col_ptr, nz_src, n_tiles, out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared-passive group: for every consumer i of one passive table m_p,
// out_i = ema(m_a_i, m_p @ A, IA_i, IP_i), from one launch whose SpMM leg
// runs once and never writes y = m_p @ A to device memory.
//
// Replaces the TPU kernel fused_spmm_ema_shared_pallas (src/repro/kernels/
// fused/pallas_fused.py, _shared_kernel and fused_spmm_ema_shared_pallas),
// which accumulated y in one VMEM scratch over a sequential grid axis and
// then ran every consumer's one-hot selection matmuls against it.
//
// Here one CUDA block owns (destination tile, TV-column slice, colouring b):
//   1. it accumulates y[c_p, TV] in dynamic shared memory over the tile's
//      block run (bsr_tile.cuh), once for the whole group;
//   2. for each consumer in turn it writes
//      out_i[b, j, v] = sum_l m_a_i[b, IA_i[j, l], v] * y[IP_i[j, l], v],
//      indexing rows of y in shared memory directly.
// A consumer with S >= 8 output rows takes one row per warp, as
// fused_spmm_ema.cu does. A consumer with fewer rows (a template root has
// S = 1, L = C(k, t_a) terms) would leave warps idle that way, so its L
// terms are split across the WARPS / S warps of a row: each warp sums a
// strided share of the terms, writes its partial to shared memory, and the
// row's first warp adds the partials in warp order. The order is fixed and
// there are no atomics. Sums are f32 for f32 and bf16 storage.
//
// The consumers' pointers and dims arrive as a small device array of
// GroupMember rows (kernels/fused/ops.py builds it); the wrapper raises
// above MAX_GROUP consumers.
//
// What bounds it on the H100: the dense-block SpMM leg on CUDA cores (~150x
// the useful multiply-adds on a road-like graph; fused_spmm_ema.cu walks
// only the nonzeros), paid once per group instead of once per consumer;
// then the m_a row reads of the split combinations (device-memory bytes).
// Shared memory: y takes c_p * TV * 4 bytes beside 32 KB of staging and a
// 1 KB reduction buffer (the fit model is fused_group_fits_smem).
#include "bsr_tile.cuh"

namespace {

constexpr int MAX_GROUP = 16;

// One consumer of the group: device pointers and dims, as int64 fields.
struct GroupMember {
  long long m_a;  // (batch, c_a, n) storage dtype
  long long ia;   // (s, l) int32
  long long ip;   // (s, l) int32
  long long out;  // (batch, s, n) storage dtype
  long long c_a, s, l, pad;
};

template <typename T>
__global__ void __launch_bounds__(rt::THREADS)
    shared_kernel(const T* __restrict__ m_p, int c_p, long long n,
                  const T* __restrict__ blocks,
                  const int* __restrict__ src_tile,
                  const int* __restrict__ tile_ptr,
                  const GroupMember* __restrict__ members, int n_members) {
  extern __shared__ float smem[];
  float* blk_s = smem;
  float* m_s = blk_s + rt::TILE * rt::TV;
  float* y = m_s + rt::STAGE * rt::TILE;
  float* red = y + c_p * rt::TV;  // WARPS x TV split partials
  const int slices = rt::TILE / rt::TV;
  const int tile = blockIdx.x / slices;
  const int col0 = (blockIdx.x % slices) * rt::TV;
  const long long b = blockIdx.y;
  rt::bsr_run_accumulate(m_p + b * c_p * n, n, c_p, blocks, src_tile,
                         tile_ptr[tile], tile_ptr[tile + 1], col0, y, blk_s,
                         m_s);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long v = (long long)tile * rt::TILE + col0 + lane;
  const bool live = v < n;  // no early return: the loop below syncs
  for (int i = 0; i < n_members; ++i) {
    const GroupMember mb = members[i];
    const int s = (int)mb.s;
    const int l = (int)mb.l;
    const T* ma = reinterpret_cast<const T*>(mb.m_a) + b * mb.c_a * n + v;
    const int* ia = reinterpret_cast<const int*>(mb.ia);
    const int* ip = reinterpret_cast<const int*>(mb.ip);
    T* o = reinterpret_cast<T*>(mb.out) + b * mb.s * n + v;
    // warps per output row (uniform over the block, so the barriers below
    // are reached by every thread) and rows per pass of all warps
    const int wpr = s >= rt::WARPS ? 1 : rt::WARPS / s;
    const int rows_per_pass = rt::WARPS / wpr;
    const int part = warp % wpr;
    for (int j0 = 0; j0 < s; j0 += rows_per_pass) {
      const int j = j0 + warp / wpr;
      const bool mine = live && j < s;
      float acc = 0.f;
      if (mine) {
        const int* a_idx = ia + (long long)j * l;
        const int* p_idx = ip + (long long)j * l;
        for (int q = part; q < l; q += wpr)
          acc += rt::to_f32(ma[a_idx[q] * n]) * y[p_idx[q] * rt::TV + lane];
      }
      if (wpr == 1) {
        if (mine) o[j * n] = rt::from_f32<T>(acc);
        continue;
      }
      red[warp * rt::TV + lane] = acc;
      __syncthreads();
      if (mine && part == 0) {
        float sum = 0.f;
        for (int p = 0; p < wpr; ++p) sum += red[(warp + p) * rt::TV + lane];
        o[j * n] = rt::from_f32<T>(sum);
      }
      __syncthreads();  // red is reused by the next pass
    }
  }
}

template <typename T>
int launch(const void* m_p, int c_p, long long n, int batch,
           const void* blocks, const int* src_tile, const int* tile_ptr,
           int n_tiles, const void* members, int n_members,
           cudaStream_t stream) {
  if (n_members < 1 || n_members > MAX_GROUP)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      (long long)(rt::WALK_SMEM_FLOATS + c_p * rt::TV + rt::WARPS * rt::TV) *
      sizeof(float);
  if (smem > rt::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      shared_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_tiles * (rt::TILE / rt::TV), batch);
  shared_kernel<T><<<grid, rt::THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(m_p), c_p, n, static_cast<const T*>(blocks),
      src_tile, tile_ptr, static_cast<const GroupMember*>(members),
      n_members);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Tables are contiguous (batch, rows, n);
// members points to n_members GroupMember rows in device memory.
// Returns the cudaError_t of the launch.
extern "C" int rt_fused_spmm_ema_shared(int dtype, const void* m_p, int c_p,
                                        long long n, int batch,
                                        const void* blocks,
                                        const int* src_tile,
                                        const int* tile_ptr, int n_tiles,
                                        const void* members, int n_members,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(m_p, c_p, n, batch, blocks, src_tile, tile_ptr,
                         n_tiles, members, n_members, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(m_p, c_p, n, batch, blocks, src_tile,
                                 tile_ptr, n_tiles, members, n_members, st);
  return (int)cudaErrorInvalidValue;
}

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
//   1. it starts copying the first consumer's m_a[b, :, slice] into shared
//      memory (cp.async), when those c_a rows fit A_SLICE_BYTES;
//   2. meanwhile it sums y[c_p, TV] in shared memory over the nonzeros of
//      the tile's block run that fall in its slice, once for the whole
//      group (the slice walk of bsr_sparse_tile.cuh, as fused_spmm_ema.cu:
//      each listed source loaded straight into registers);
//   3. for each consumer in turn it writes
//      out_i[b, j, v] = sum_l m_a_i[b, IA_i[j, l], v] * y[IP_i[j, l], v],
//      a lane two adjacent columns, with m_a's rows from the slice in
//      shared memory (a later consumer's slice is copied in when the one
//      before is done) or, when its slice is wider than A_SLICE_BYTES,
//      straight from device memory.
// The split tables come into shared memory IDX_TERMS (IA, IP) pairs at a
// time, each read once a block. A consumer with S > WARPS output rows
// takes one half-warp a row. One with fewer rows (a template root has
// S = 1, L = C(k, t_a) terms) splits each row's terms across the halves of
// WARPS / S warps: each half sums a strided share, a warp's two halves add
// by __shfl_xor, the warps' partials meet in shared memory and the row's
// first warp adds them in warp order. The order is fixed and there are no
// atomics. Sums are f32 for f32 and bf16 storage.
//
// The consumers' pointers and dims arrive as a small device array of
// GroupMember rows (kernels/fused/ops.py builds it); the wrapper raises
// above MAX_GROUP consumers.
//
// What bounds it on the H100: the SpMM leg's reads of each listed source
// value (from L2 mostly: a source row is listed by ~3 destination tiles
// on a mesh), paid once a group instead of once a consumer; then each
// consumer's m_a, read once (device-memory bytes), which other blocks'
// legs overlap. Four blocks share an SM while one takes at most 56 KB of
// shared memory (c_p = 210 in f32: 54.8 KB; c_p = 252: 65.5, three
// blocks). Shared memory: the
// widest staged m_a slice (at most A_SLICE_BYTES), y's c_p * TV * 4 bytes
// and WARPS * TV * 4 bytes of split partials, which hold a chunk of the
// split table before (the fit model is fused_group_fits_smem).
#include "bsr_sparse_tile.cuh"

namespace {

constexpr int MAX_GROUP = 16;
// blocks an SM the register budget is set for (__launch_bounds__): at
// four ptxas keeps the kernel in 64 registers without spilling, and the
// leg, which waits on L2, has twice the warps in flight it had at two
// (102-114 registers): on the H100 2.3 ms against 4.3 at c_p = 210, B = 2
constexpr int MIN_BLOCKS = 4;
constexpr int HALVES = rt::THREADS / 16;  // half-warps of a block
// split-table terms staged at once: (IA, IP) int2s in the WARPS x TV
// floats of the split partials
constexpr int IDX_TERMS = rt::WARPS * rt::TV / 2;

// One consumer of the group: device pointers and dims, as int64 fields.
struct GroupMember {
  long long m_a;  // (batch, c_a, n) storage dtype
  long long ia;   // (s, l) int32
  long long ip;   // (s, l) int32
  long long out;  // (batch, s, n) storage dtype
  long long c_a, s, l, pad;
};

// DIRECT: some consumer's m_a is wider than A_SLICE_BYTES and read from
// device memory (a census group's never is)
template <typename T, bool DIRECT>
__global__ void __launch_bounds__(rt::THREADS, MIN_BLOCKS)
    shared_kernel(const T* __restrict__ m_p, int c_p, long long n,
                  int a_rows, const int* __restrict__ src_tile,
                  const int* __restrict__ tile_ptr,
                  const int* __restrict__ col_ptr,
                  const unsigned char* __restrict__ nz_src,
                  const GroupMember* __restrict__ members, int n_members) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem);  // a_rows x TV
  float* y = reinterpret_cast<float*>(smem + (size_t)a_rows * rt::TV *
                                                 sizeof(T));
  float* red = y + c_p * rt::TV;  // WARPS x TV split partials
  int2* idx = reinterpret_cast<int2*>(red);  // or IDX_TERMS split terms
  const int tile = blockIdx.x / rt::SLICES;
  const int col0 = (blockIdx.x % rt::SLICES) * rt::TV;
  const long long b = blockIdx.y;
  const long long v0 = (long long)tile * rt::TILE + col0;
  if (members[0].c_a <= a_rows)
    rt::stage_slice(a_s, reinterpret_cast<const T*>(members[0].m_a) +
                             b * members[0].c_a * n,
                    (int)members[0].c_a, n, v0);
  rt::bsr_slice_run_accumulate(m_p + b * c_p * n, n, c_p, src_tile, col_ptr,
                               nz_src, tile_ptr[tile], tile_ptr[tile + 1],
                               col0, y);
  const int hw = threadIdx.x >> 4;
  const int half = hw & 1;
  const int warp = threadIdx.x >> 5;
  const int c = 2 * (threadIdx.x & 15);
  const long long v = v0 + c;
  const bool live = v < n;  // no early return: the loops below sync
  const bool both = v + 1 < n;
  const bool vec = n % 2 == 0;  // v is even: a pair load or store is aligned
  for (int i = 0; i < n_members; ++i) {
    const GroupMember mb = members[i];
    const int s = (int)mb.s, l = (int)mb.l;
    const T* ma = reinterpret_cast<const T*>(mb.m_a) + b * mb.c_a * n;
    const int* ia = reinterpret_cast<const int*>(mb.ia);
    const int* ip = reinterpret_cast<const int*>(mb.ip);
    T* o = reinterpret_cast<T*>(mb.out) + b * mb.s * n + v;
    // uniform over the block; always when !DIRECT
    const bool staged = !DIRECT || mb.c_a <= a_rows;
    if (staged && i > 0) {
      __syncthreads();  // the previous consumer's readers of a_s are done
      rt::stage_slice(a_s, ma, (int)mb.c_a, n, v0);
    }
    // the first chunk's barrier below makes the slice visible to all
    if (staged) rt::cp_async_wait<0>();
    const bool pair_load =
        vec && (reinterpret_cast<std::uintptr_t>(ma) & (2 * sizeof(T) - 1)) ==
                   0;
    // half-warps a row (1, or the two halves of WARPS / S warps), rows a
    // pass, and a row's terms in one staged chunk; all uniform, so every
    // thread reaches the barriers below
    const int hpr = s > rt::WARPS ? 1 : 2 * (rt::WARPS / max(s, 1));
    const int rpp = HALVES / hpr;
    const int q_chunk = IDX_TERMS / rpp;
    const int row = hw / hpr, part = hw % hpr;
    for (int j0 = 0; j0 < s; j0 += rpp) {
      const int j = j0 + row;
      float2 acc = make_float2(0.f, 0.f);
      for (int q0 = 0; q0 < l; q0 += q_chunk) {
        // earlier readers of idx / red are done; for the first chunk, y and
        // the staged slice are complete for every thread
        __syncthreads();
        if (threadIdx.x < IDX_TERMS) {
          const int jj = j0 + threadIdx.x / q_chunk;
          const int q = q0 + threadIdx.x % q_chunk;
          if (jj < s && q < l)
            idx[threadIdx.x] = make_int2(ia[jj * l + q], ip[jj * l + q]);
        }
        __syncthreads();
        const int nq = min(q_chunk, l - q0);
        if (j < s) {
          const int2* t = idx + row * q_chunk;
#pragma unroll 4
          for (int q = part; q < nq; q += hpr) {
            const int2 e = t[q];
            float2 x;
            if (staged) {
              x = rt::pair_at(a_s + e.x * rt::TV, c);
            } else if (pair_load) {
              x = live ? rt::pair_at(ma + (long long)e.x * n + v, 0)
                       : make_float2(0.f, 0.f);
            } else {
              const T* r = ma + (long long)e.x * n + v;
              x.x = live ? rt::to_f32(r[0]) : 0.f;
              x.y = both ? rt::to_f32(r[1]) : 0.f;
            }
            const float2 z = rt::pair_at(y + e.y * rt::TV, c);
            acc.x += x.x * z.x;
            acc.y += x.y * z.y;
          }
        }
      }
      if (hpr == 1) {
        if (live && j < s) rt::store_pair(o + (long long)j * n, acc, both,
                                          vec);
        continue;
      }
      // a warp's two halves summed the same row: add them, then the row's
      // warps' partials in warp order
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, 16);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, 16);
      __syncthreads();  // the last chunk's readers of idx are done
      if (half == 0) *reinterpret_cast<float2*>(red + warp * rt::TV + c) = acc;
      __syncthreads();
      const int wpr = hpr / 2;
      if (half == 0 && warp % wpr == 0 && live && j < s) {
        float2 sum = make_float2(0.f, 0.f);
        for (int w = warp; w < warp + wpr; ++w) {
          const float2 p = *reinterpret_cast<const float2*>(red + w * rt::TV +
                                                            c);
          sum.x += p.x;
          sum.y += p.y;
        }
        rt::store_pair(o + (long long)j * n, sum, both, vec);
      }
    }
  }
}

template <typename T>
int launch(const void* m_p, int c_p, long long n, int batch, int a_rows,
           int n_staged, const int* src_tile, const int* tile_ptr,
           const int* col_ptr, const unsigned char* nz_src, int n_tiles,
           const void* members, int n_members, cudaStream_t stream) {
  const long long a_bytes = (long long)a_rows * rt::TV * sizeof(T);
  if (n_members < 1 || n_members > MAX_GROUP || a_rows < 0 ||
      a_bytes > rt::A_SLICE_BYTES || n_staged < 0 ||
      n_staged > n_members || (a_rows > 0) != (n_staged > 0))
    return (int)cudaErrorInvalidValue;
  const long long smem =
      a_bytes + (long long)(c_p + rt::WARPS) * rt::TV * sizeof(float);
  if (smem > rt::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = n_staged < n_members ? shared_kernel<T, true>
                                     : shared_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_tiles * rt::SLICES, batch);
  kernel<<<grid, rt::THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(m_p), c_p, n, a_rows, src_tile, tile_ptr,
      col_ptr, nz_src, static_cast<const GroupMember*>(members), n_members);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Tables are contiguous (batch, rows, n);
// members points to n_members GroupMember rows in device memory. a_rows
// is the largest c_a of the members whose m_a slice fits A_SLICE_BYTES
// (0 when none does) and n_staged their number: those are staged, the
// others read directly. Returns the cudaError_t of the launch.
extern "C" int rt_fused_spmm_ema_shared(int dtype, const void* m_p, int c_p,
                                        long long n, int batch, int a_rows,
                                        int n_staged, const int* src_tile,
                                        const int* tile_ptr,
                                        const int* col_ptr,
                                        const unsigned char* nz_src,
                                        int n_tiles, const void* members,
                                        int n_members, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(m_p, c_p, n, batch, a_rows, n_staged, src_tile,
                         tile_ptr, col_ptr, nz_src, n_tiles, members,
                         n_members, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(m_p, c_p, n, batch, a_rows, n_staged,
                                 src_tile, tile_ptr, col_ptr, nz_src, n_tiles,
                                 members, n_members, st);
  return (int)cudaErrorInvalidValue;
}

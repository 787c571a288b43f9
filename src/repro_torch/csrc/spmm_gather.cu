// Gather SpMM, Y = M @ A, for a (rows, n) count table M over the
// destination-sorted edge stream: Y[r, v] = sum of M[r, src[e]] over
// e in row_ptr[v] .. row_ptr[v+1].
//
// Replaces the TPU kernel spmm_gather_pallas (src/repro/kernels/spmm/
// pallas_gather.py, _kernel and spmm_gather_pallas), which cut each
// (destination tile, source tile) pair's edges into padded 512-edge chunks,
// densified every chunk into a 128x128 tile with one-hot outer products
// and multiplied it on the MXU, carrying the output tile in VMEM across a
// sequential grid axis. The densify step exists for the MXU; here the
// kernel gathers the source columns directly and sums them per
// destination, so no chunk padding and no blocks are needed.
//
// Layout: a warp owns one destination v and GATHER_ROWS = 32 rows of M, a
// lane one row. The warp loads 32 source ids at a time with one coalesced
// read and broadcasts them with shuffles; each lane then reads its row's
// entries. A CUDA block holds GATHER_DSTS = 8 consecutive destinations of
// the same rows and writes its 32 x 8 results through shared memory, so
// each row's 8 outputs leave as one 32-byte segment.
//
// Load balance: a social graph's degrees are skewed (rmat(20) has a vertex
// of degree 64,701 beside 402,533 isolated ones). One block per
// destination tile would leave a whole tile's work to one block; a warp per
// destination bounds the longest serial run by the largest degree, and the
// grid (n/8 x rows/32 blocks) keeps every SM busy meanwhile. The order of
// the sum is fixed: four running sums over the edges in stream order,
// added pairwise at the end. No atomics.
//
// Index width: rows x n passes 2^31 (792 colour sets x 1M vertices x a
// batch), so row offsets are 64-bit; the edge pointer is int64 too.
//
// What bounds it on the H100: device-memory traffic of the gathers. Each
// lane reads 4 (bf16: 2) bytes of a 32-byte sector, as a warp's 32 rows lie
// n elements apart, so the kernel moves up to 8x the bytes of its bound
// unless the sources' sectors stay in L2 (the hubs of a power-law graph
// do). Sums are f32 for f32 and bf16 storage.
#include "bsr_tile.cuh"

namespace {

constexpr int GATHER_ROWS = 32;  // rows of M per warp: one per lane
constexpr int GATHER_DSTS = 8;   // destinations per CUDA block: one per warp
constexpr int GATHER_THREADS = GATHER_ROWS * GATHER_DSTS;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
    gather_kernel(const T* __restrict__ m, int rows, long long n,
                  const int* __restrict__ src,
                  const long long* __restrict__ row_ptr,
                  T* __restrict__ out) {
  __shared__ float res[GATHER_ROWS][GATHER_DSTS + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long v0 = (long long)blockIdx.x * GATHER_DSTS;
  const long long v = v0 + warp;
  const int r0 = blockIdx.y * GATHER_ROWS;
  const int r = r0 + lane;
  const bool row_ok = r < rows;
  float acc = 0.f;
  if (v < n) {  // uniform over the warp: every lane takes the shuffles
    const T* mr = m + (long long)(row_ok ? r : r0) * n;
    const long long e0 = row_ptr[v];
    const long long e1 = row_ptr[v + 1];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (long long eb = e0; eb < e1; eb += 32) {
      const int cnt = (int)(e1 - eb < 32 ? e1 - eb : 32);
      const int mine = lane < cnt ? src[eb + lane] : 0;
      int q = 0;
      for (; q + 4 <= cnt; q += 4) {
        const int u0 = __shfl_sync(FULL_MASK, mine, q);
        const int u1 = __shfl_sync(FULL_MASK, mine, q + 1);
        const int u2 = __shfl_sync(FULL_MASK, mine, q + 2);
        const int u3 = __shfl_sync(FULL_MASK, mine, q + 3);
        if (row_ok) {
          a0 += rt::to_f32(mr[u0]);
          a1 += rt::to_f32(mr[u1]);
          a2 += rt::to_f32(mr[u2]);
          a3 += rt::to_f32(mr[u3]);
        }
      }
      for (; q < cnt; ++q) {
        const int u = __shfl_sync(FULL_MASK, mine, q);
        if (row_ok) a0 += rt::to_f32(mr[u]);
      }
    }
    acc = (a0 + a1) + (a2 + a3);
  }
  res[lane][warp] = acc;
  __syncthreads();
  const int rr = threadIdx.x / GATHER_DSTS;
  const int d = threadIdx.x % GATHER_DSTS;
  const long long vv = v0 + d;
  if (r0 + rr < rows && vv < n)
    out[(long long)(r0 + rr) * n + vv] = rt::from_f32<T>(res[rr][d]);
}

template <typename T>
int launch(const void* m, int rows, long long n, const int* src,
           const long long* row_ptr, void* out, cudaStream_t stream) {
  const long long dst_blocks = (n + GATHER_DSTS - 1) / GATHER_DSTS;
  const long long row_blocks = (rows + GATHER_ROWS - 1) / GATHER_ROWS;
  if (dst_blocks > 0x7fffffffLL || row_blocks > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)dst_blocks, (unsigned)row_blocks);
  gather_kernel<T><<<grid, GATHER_THREADS, 0, stream>>>(
      static_cast<const T*>(m), rows, n, src, row_ptr, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (storage; the sums are f32 either way).
// Returns the cudaError_t of the launch.
extern "C" int rt_spmm_gather(int dtype, const void* m, int rows,
                              long long n, const int* src,
                              const long long* row_ptr, void* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(m, rows, n, src, row_ptr, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(m, rows, n, src, row_ptr, out, s);
  return (int)cudaErrorInvalidValue;
}

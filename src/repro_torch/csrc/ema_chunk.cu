// Chunk-accumulate step of the colorset-chunked eMA:
//   out[b, rows[e], v] += sum over the entry's pairs t of
//                         m_a[b, pair_a[t], v] * y_c[b, pair_p[t], v]
// for every entry e of one chunk (kernels/ema/ops.py, ChunkWalk).
//
// Replaces the pair loop of the JAX package's ema_chunked
// (src/repro/kernels/ema/ops.py, ema_chunked: a scan of 128-pair
// scatter-adds, XLA ops, no Pallas kernel). When one coloring's tables do
// not fit the memory budget, the executor walks a node's passive colour
// sets a chunk of rows at a time: one SpMM gives the chunk's neighbour sums
// y_c, and this kernel adds the chunk's (output, active, passive) pairs into
// the node's one accumulating output. A launch per chunk.
//
// One thread owns one output element of one entry (an output row the chunk
// touches): it reads the element once, adds the entry's pairs in the pack's
// order, each product and sum in f32 with no fused multiply-add (so the sum
// is the plain version's, bit for bit), and stores it once, rounded to the
// table's dtype. No atomics, and the order is fixed. The pack pads each
// chunk to 128 pair slots; the walk keeps only the real pairs (6 of 128 a
// chunk at u13's chunked node), so the kernel never touches padding.
//
// What bounds it on the H100: device-memory bytes. Each touched output row
// is read and written once a chunk, each pair's m_a row and y_c row read
// once (m_a's few rows are shared by many chunks and partly stay in L2).
// Threads run along v, so every access is coalesced.
#include "bsr_tile.cuh"

namespace {

constexpr int CA_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(CA_THREADS)
    ema_chunk_acc_kernel(const T* __restrict__ m_a, const T* __restrict__ y_c,
                         const int* __restrict__ rows,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ pair_a,
                         const int* __restrict__ pair_p, int e0, int c_a,
                         int r, int s, long long n, T* __restrict__ out) {
  const long long v = (long long)blockIdx.x * CA_THREADS + threadIdx.x;
  if (v >= n) return;
  const int e = e0 + (int)blockIdx.y;
  const long long b = blockIdx.z;
  T* o = out + (b * s + rows[e]) * n + v;
  const T* ma = m_a + b * c_a * n + v;
  const T* yc = y_c + b * r * n + v;
  float acc = rt::to_f32(*o);
  const int t1 = row_ptr[e + 1];
  for (int t = row_ptr[e]; t < t1; ++t)
    acc = __fadd_rn(acc, __fmul_rn(rt::to_f32(ma[(long long)pair_a[t] * n]),
                                   rt::to_f32(yc[(long long)pair_p[t] * n])));
  *o = rt::from_f32<T>(acc);
}

template <typename T>
int launch(const void* m_a, const void* y_c, const int* rows,
           const int* row_ptr, const int* pair_a, const int* pair_p, int e0,
           int n_entries, int c_a, int r, int s, long long n, int batch,
           void* out, cudaStream_t stream) {
  if (n_entries > 65535 || batch > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const long long col_blocks = (n + CA_THREADS - 1) / CA_THREADS;
  const dim3 grid((unsigned)col_blocks, (unsigned)n_entries, (unsigned)batch);
  ema_chunk_acc_kernel<T><<<grid, CA_THREADS, 0, stream>>>(
      static_cast<const T*>(m_a), static_cast<const T*>(y_c), rows, row_ptr,
      pair_a, pair_p, e0, c_a, r, s, n, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (storage; the sums are f32 either way). The
// chunk's entries are e0 .. e0 + n_entries - 1; m_a is (batch, c_a, n),
// y_c (batch, r, n), out (batch, s, n), all contiguous; out is updated in
// place. Returns the cudaError_t of the launch.
extern "C" int rt_ema_chunk_acc(int dtype, const void* m_a, const void* y_c,
                                const int* rows, const int* row_ptr,
                                const int* pair_a, const int* pair_p, int e0,
                                int n_entries, int c_a, int r, int s,
                                long long n, int batch, void* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(m_a, y_c, rows, row_ptr, pair_a, pair_p, e0,
                         n_entries, c_a, r, s, n, batch, out, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(m_a, y_c, rows, row_ptr, pair_a, pair_p, e0,
                                 n_entries, c_a, r, s, n, batch, out, st);
  return (int)cudaErrorInvalidValue;
}

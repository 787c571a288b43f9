// eMA: out[b, j, v] = sum_l m_a[b, IA[j, l], v] * y_p[b, IP[j, l], v].
//
// Replaces the TPU kernel ema_pallas (src/repro/kernels/ema/pallas_ema.py,
// _kernel and ema_pallas), which kept both child tables resident in VMEM
// per vertex block and gathered rows with dynamic sublane indexing.
//
// An input row is selected by S * L / C output rows (6 for m_a at u12's
// node 6), so the kernel's work is to read each from device memory once
// per colouring. Two paths, chosen by the wrapper (kernels/ema/ops.py):
//   * staged: a CUDA block owns W columns of one colouring and all S
//     output rows. It stages m_a[b, :, slice] and y_p[b, :, slice]
//     (c_a + c_p rows of 4W bytes in f32) into shared memory with
//     cp.async, once, then computes every output row from there: W / 2
//     lanes (a half-warp at W = 32) take a row, a lane two adjacent
//     columns, and they sum EMA_ROWS_AT_ONCE rows side by side. The split table comes
//     packed as element offsets into the slice, two terms to an int4
//     (pack_pairs_kernel, one small launch first), so a term costs one
//     broadcast read every other term besides its two operand reads.
//     Taken when S > 8 and a 32-column slice fits a block's shared memory
//     (c_a + c_p <= 1,816 in f32, 3,632 in bf16).
//   * direct: a CUDA block takes ROWS output rows and EMA_THREADS columns
//     and reads its rows from device memory, threads along v. The blocks
//     of one column range run one after another (the row blocks are the
//     fastest grid index), so the rows they share come from L2. Taken
//     when S <= 8 (one row block: each input row is read once anyway, as
//     at a census root) or the slice does not fit.
// The launch shape is the autotuner's choice (kernels/autotune.py,
// ema_blocks): the slice width W of the staged path (16, 32 or 64; 32 by
// default) or the output rows ROWS of a direct block (4, 8 or 16; 8 by
// default), one instantiation each. Neither changes the order of a sum.
// Both sum the L terms of an output in ascending l, in f32 for f32 and
// bf16 storage, round once at the store and write exactly the (B, S, n)
// output: rows past S and columns past n are never touched.
//
// What bounds it on the H100 (staged path): shared-memory reads, two a
// term, which at u12's node 6 take about as long as the device-memory
// traffic, and in f32 one block fills an SM (120 KB of slice), so a
// block's copy-in and its sums do not overlap; bf16 fits three blocks an
// SM. The direct path is bound by device-memory bytes at S = 1.
#include "bsr_sparse_tile.cuh"

namespace {

constexpr int EMA_THREADS = 256;         // direct path: columns of a block
constexpr int EMA_STAGED_THREADS = 512;  // staged path: 16 warps
constexpr int EMA_ROWS_AT_ONCE = 2;      // staged path: a lane group's rows

// The staged path's split table: a term's m_a and y_p rows as element
// offsets into the staged slice of w columns (y_p's rows follow m_a's),
// two terms to an int4, so one broadcast read brings both offsets of two
// terms; the last int4 of a row with odd L holds one. pairs has s * ((l +
// 1) / 2) int4s.
__global__ void pack_pairs_kernel(const int* __restrict__ ia,
                                  const int* __restrict__ ip, int s, int l,
                                  int c_a, int w, int4* __restrict__ pairs) {
  const int halves = (l + 1) / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s * halves) return;
  const int j = i / halves, q = j * l + 2 * (i % halves);
  const bool two = 2 * (i % halves) + 1 < l;
  pairs[i] = make_int4(ia[q] * w, (c_a + ip[q]) * w, two ? ia[q + 1] * w : 0,
                       two ? (c_a + ip[q + 1]) * w : 0);
}

__device__ __forceinline__ void fma_pair(float2& acc, float2 x, float2 z) {
  acc.x += x.x * z.x;
  acc.y += x.y * z.y;
}

template <typename T, int EMA_W>
__global__ void __launch_bounds__(EMA_STAGED_THREADS)
    ema_staged_kernel(const T* __restrict__ m_a, const T* __restrict__ y_p,
                      const int4* __restrict__ pairs, int s, int l, int c_a,
                      int c_p, long long n, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int PIECES = EMA_W / VEC;
  const int rows = c_a + c_p;
  T* tab = reinterpret_cast<T*>(smem);  // c_a m_a rows, then c_p y_p rows
  const long long v0 = (long long)blockIdx.x * EMA_W;
  const long long b = blockIdx.y;
  const T* ma = m_a + b * c_a * n;
  const T* yp = y_p + b * c_p * n;
  const bool vec = n % VEC == 0 &&
                   (reinterpret_cast<std::uintptr_t>(m_a) & 15) == 0 &&
                   (reinterpret_cast<std::uintptr_t>(y_p) & 15) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < rows * PIECES; i += EMA_STAGED_THREADS) {
      const int r = i / PIECES, q = i % PIECES;
      const T* row = r < c_a ? ma + r * n : yp + (r - c_a) * n;
      const long long v = v0 + q * VEC;
      const bool in = v < n;
      rt::cp_async16(tab + r * EMA_W + q * VEC, in ? row + v : ma,
                     in ? 16 : 0);
    }
    rt::cp_async_commit();
    rt::cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < rows * EMA_W; i += EMA_STAGED_THREADS) {
      const int r = i / EMA_W, c = i % EMA_W;
      const T* row = r < c_a ? ma + r * n : yp + (r - c_a) * n;
      const long long v = v0 + c;
      tab[i] = v < n ? row[v] : rt::from_f32<T>(0.f);
    }
  }
  __syncthreads();
  // EMA_W / 2 lanes take an output row, a lane two adjacent columns
  constexpr int LANES = EMA_W / 2;
  static_assert(32 % LANES == 0 || LANES % 32 == 0, "lanes tile warps");
  const int c = 2 * (threadIdx.x % LANES);
  const long long v = v0 + c;
  if (v >= n) return;
  const bool both = v + 1 < n;
  const bool pair_store = n % 2 == 0;  // v is even: aligned
  const int halves = l / 2, odd = l & 1;
  T* o = out + b * s * n + v;
  // each group of LANES lanes sums EMA_ROWS_AT_ONCE consecutive output
  // rows side by side, so the latency of each step's reads is paid once
  // for all of them
  constexpr int R = EMA_ROWS_AT_ONCE;
  for (int j0 = threadIdx.x / LANES * R; j0 < s;
       j0 += EMA_STAGED_THREADS / LANES * R) {
    const int4* pj[R];
    float2 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      pj[r] = pairs + min(j0 + r, s - 1) * (halves + odd);
      acc[r] = make_float2(0.f, 0.f);
    }
    for (int h = 0; h < halves; ++h) {
      int4 t[R];
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = __ldg(pj[r] + h);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fma_pair(acc[r], rt::pair_at(tab + t[r].x, c),
                 rt::pair_at(tab + t[r].y, c));
        fma_pair(acc[r], rt::pair_at(tab + t[r].z, c),
                 rt::pair_at(tab + t[r].w, c));
      }
    }
    if (odd) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int4 t = __ldg(pj[r] + halves);
        fma_pair(acc[r], rt::pair_at(tab + t.x, c),
                 rt::pair_at(tab + t.y, c));
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (j0 + r < s)
        rt::store_pair(o + (long long)(j0 + r) * n, acc[r], both,
                       pair_store);
  }
}

template <typename T, int EMA_ROWS>
__global__ void __launch_bounds__(EMA_THREADS)
    ema_direct_kernel(const T* __restrict__ m_a, const T* __restrict__ y_p,
                      const int* __restrict__ ia, const int* __restrict__ ip,
                      int s, int l, int c_a, int c_p, long long n,
                      int row_blocks, T* __restrict__ out) {
  extern __shared__ int idx_s[];  // IA rows, then IP rows of this block
  const int j0 = (int)(blockIdx.x % row_blocks) * EMA_ROWS;
  const long long v =
      (long long)(blockIdx.x / row_blocks) * EMA_THREADS + threadIdx.x;
  const int nj = min(EMA_ROWS, s - j0);
  for (int i = threadIdx.x; i < nj * l; i += EMA_THREADS) {
    idx_s[i] = ia[j0 * l + i];
    idx_s[EMA_ROWS * l + i] = ip[j0 * l + i];
  }
  __syncthreads();
  if (v >= n) return;
  const long long b = blockIdx.y;
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

template <typename T, int EMA_W>
int launch_staged(const void* m_a, const void* y_p, const int* ia,
                  const int* ip, int s, int l, int c_a, int c_p, long long n,
                  int batch, void* pairs, void* out, cudaStream_t stream) {
  const long long staged = (long long)(c_a + c_p) * EMA_W * sizeof(T);
  if (staged > rt::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ema_staged_kernel<T, EMA_W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)staged);
  if (e != cudaSuccess) return (int)e;
  int4* packed = static_cast<int4*>(pairs);
  const int n_pairs = s * ((l + 1) / 2);
  pack_pairs_kernel<<<(n_pairs + 255) / 256, 256, 0, stream>>>(
      ia, ip, s, l, c_a, EMA_W, packed);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + EMA_W - 1) / EMA_W), batch);
  ema_staged_kernel<T, EMA_W>
      <<<grid, EMA_STAGED_THREADS, (size_t)staged, stream>>>(
          static_cast<const T*>(m_a), static_cast<const T*>(y_p), packed, s,
          l, c_a, c_p, n, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T, int EMA_ROWS>
int launch_direct(const void* m_a, const void* y_p, const int* ia,
                  const int* ip, int s, int l, int c_a, int c_p, long long n,
                  int batch, void* out, cudaStream_t stream) {
  const long long smem = 2LL * EMA_ROWS * l * (long long)sizeof(int);
  if (smem > rt::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ema_direct_kernel<T, EMA_ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int row_blocks = (s + EMA_ROWS - 1) / EMA_ROWS;
  const long long col_blocks = (n + EMA_THREADS - 1) / EMA_THREADS;
  if (col_blocks * row_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(col_blocks * row_blocks), batch);
  ema_direct_kernel<T, EMA_ROWS><<<grid, EMA_THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(m_a), static_cast<const T*>(y_p), ia, ip, s, l,
      c_a, c_p, n, row_blocks, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// s_block 0: the staged path, slices of n_block columns; otherwise the
// direct path, s_block output rows of n_block = EMA_THREADS columns
template <typename T>
int launch(int s_block, int n_block, const void* m_a, const void* y_p,
           const int* ia, const int* ip, int s, int l, int c_a, int c_p,
           long long n, int batch, void* pairs, void* out,
           cudaStream_t stream) {
  if (s_block == 0) {
    switch (n_block) {
#define RT_STAGED(W)                                                       \
  case W:                                                                  \
    return launch_staged<T, W>(m_a, y_p, ia, ip, s, l, c_a, c_p, n, batch, \
                               pairs, out, stream);
      RT_STAGED(16)
      RT_STAGED(32)
      RT_STAGED(64)
#undef RT_STAGED
    }
    return (int)cudaErrorInvalidValue;
  }
  if (n_block != EMA_THREADS) return (int)cudaErrorInvalidValue;
  switch (s_block) {
#define RT_DIRECT(R)                                                       \
  case R:                                                                  \
    return launch_direct<T, R>(m_a, y_p, ia, ip, s, l, c_a, c_p, n, batch, \
                               out, stream);
    RT_DIRECT(4)
    RT_DIRECT(8)
    RT_DIRECT(16)
#undef RT_DIRECT
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. (s_block, n_block): (0, 16 | 32 | 64) runs
// the staged path at that slice width, (4 | 8 | 16, 256) the direct path
// at that many output rows a block. Tables are contiguous (batch, rows,
// n); pairs is device scratch of s * ((l + 1) / 2) int4s (the staged
// path's split table, pack_pairs_kernel). Returns the cudaError_t of the
// launch.
extern "C" int rt_ema(int dtype, int s_block, int n_block, const void* m_a,
                      const void* y_p, const int* ia, const int* ip, int s,
                      int l, int c_a, int c_p, long long n, int batch,
                      void* pairs, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(s_block, n_block, m_a, y_p, ia, ip, s, l, c_a, c_p,
                         n, batch, pairs, out, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(s_block, n_block, m_a, y_p, ia, ip, s, l,
                                 c_a, c_p, n, batch, pairs, out, st);
  return (int)cudaErrorInvalidValue;
}

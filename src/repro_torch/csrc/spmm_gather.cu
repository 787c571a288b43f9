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
// What bounds it on the H100: device-memory traffic of the gathers, one
// random source read per edge. M is colour-major (a row holds one colour
// set over every vertex), so the RC rows of one source lie n elements
// apart and a row-per-lane gather spends a 32-byte sector on each 4-byte
// value. The design reads whole 128-byte lines instead, in three kernels
// per chunk of RC rows:
//
// 1. stage_kernel transposes the chunk M[r0 : r0 + RC, :] into the
//    vertex-major scratch S[n, RC] through a padded shared tile, so a
//    vertex's RC values are one 128-byte line (RC = 32 in f32, 64 in bf16).
//    The scratch is one chunk (n x 128 bytes), never the whole table.
// 2. gather_kernel: eight lanes own one destination and read one source's
//    line as eight 16-byte vectors; the octet's lanes load eight source ids
//    with one coalesced read (the next eight while this batch's lines are
//    in flight) and broadcast them with shuffles, then keep eight line
//    reads in flight. A CUDA block holds D destinations (128 by default,
//    four per octet), so a block waits on the sum of four runs rather than
//    on its longest one, and writes its RC x D results through shared
//    memory: each output row leaves as whole 128-byte segments. D is the
//    launch shape the autotuner chooses (kernels/autotune.py,
//    spmm_c_block): one instantiation each of 32, 64 and 128. It changes
//    neither the scratch's layout, nor the hub cut, nor any sum's order.
// 3. hub_kernel: a power-law graph has hubs (rmat(20): a vertex of degree
//    64,701), and one octet walking such a run would be the launch's tail.
//    The host cuts every run longer than hub_degree into segments of
//    hub_degree edges (GatherPrep); gather_kernel's leading blocks sum
//    one segment per octet into an f32 partial (first, so the long work
//    starts first), the destination blocks skip the hubs, and hub_kernel
//    adds each hub's partials in segment order.
//
// The order of every sum is fixed: edge k of a run (or segment) goes to
// running sum k mod 2, the two are added at the end, and a hub's segments
// are added in order. No atomics. Sums are f32 for f32 and bf16
// storage. Index width: row offsets (rows x n passes 2^31) and the edge
// pointer are 64-bit.
#include <climits>

#include "bsr_tile.cuh"

namespace {

constexpr int LINE = 128;     // bytes of a vertex's slice of the scratch
constexpr int OCT = 8;        // lanes per line: 16 bytes each
constexpr int THREADS = 256;  // 8 warps
constexpr int OCTETS = THREADS / OCT;
constexpr int STAGE_V = 32;   // vertices per transpose tile
constexpr int SUMS = 2;       // running sums per lane and value

template <typename T>
struct Cfg {
  static constexpr int RC = LINE / (int)sizeof(T);  // rows per chunk
  static constexpr int PL = 16 / (int)sizeof(T);    // values per lane
};

__device__ __forceinline__ void add16(float* a, uint4 v, float) {
  a[0] += __uint_as_float(v.x);
  a[1] += __uint_as_float(v.y);
  a[2] += __uint_as_float(v.z);
  a[3] += __uint_as_float(v.w);
}

__device__ __forceinline__ void add16(float* a, uint4 v, __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<unsigned*>(&h) = w[i];
    const float2 f = __bfloat1622float2(h);
    a[2 * i] += f.x;
    a[2 * i + 1] += f.y;
  }
}

// Sums the scratch lines of sources src[e0 .. e1) into this lane's PL
// values of the run: the eight lanes of an octet walk together (their
// shuffles name only the octet in `mask`), lane `sub` owning values
// sub * PL .. sub * PL + PL - 1 of each line.
template <typename T>
__device__ __forceinline__ void walk(const T* __restrict__ s,
                                     const int* __restrict__ src,
                                     long long e0, long long e1, int sub,
                                     unsigned mask,
                                     float (&acc)[SUMS][Cfg<T>::PL]) {
  constexpr int RC = Cfg<T>::RC, PL = Cfg<T>::PL;
  int mine = e0 + sub < e1 ? src[e0 + sub] : 0;
  for (long long eb = e0; eb < e1; eb += OCT) {
    const int cnt = (int)(e1 - eb < OCT ? e1 - eb : OCT);
    const long long nb = eb + OCT;
    const int next = nb + sub < e1 ? src[nb + sub] : 0;
    uint4 v[OCT];
#pragma unroll
    for (int q = 0; q < OCT; ++q) {
      const int u = __shfl_sync(mask, mine, q, OCT);
      v[q] = q < cnt ? __ldg(reinterpret_cast<const uint4*>(
                           s + (long long)u * RC + sub * PL))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < OCT; ++q) add16(acc[q % SUMS], v[q], T());
    mine = next;
  }
}

template <int PL>
__device__ __forceinline__ float total(const float (&acc)[SUMS][PL], int i) {
  float t = acc[0][i];
#pragma unroll
  for (int k = 1; k < SUMS; ++k) t += acc[k][i];
  return t;
}

// S[v * RC + r] = m[r * n + v] for r < nr, zero for nr <= r < RC.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    stage_kernel(const T* __restrict__ m, int nr, long long n,
                 T* __restrict__ s) {
  constexpr int RC = Cfg<T>::RC;
  __shared__ float sh[RC][STAGE_V + 1];  // +1: conflict-free columns
  const long long v0 = (long long)blockIdx.x * STAGE_V;
  for (int i = threadIdx.x; i < RC * STAGE_V; i += THREADS) {
    const int r = i / STAGE_V, c = i % STAGE_V;
    const long long v = v0 + c;
    sh[r][c] = r < nr && v < n ? rt::to_f32(m[(long long)r * n + v]) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RC * STAGE_V; i += THREADS) {
    const int c = i / RC, r = i % RC;
    const long long v = v0 + c;
    if (v < n) s[v * RC + r] = rt::from_f32<T>(sh[r][c]);
  }
}

// The first seg_blocks blocks: one hub segment per octet, its sums into
// part[j * RC ..]. The rest: D destinations each, written to y (rows nr,
// row stride n); hubs (runs longer than hub_degree) are left to hub_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 4)
    gather_kernel(const T* __restrict__ s, long long n,
                  const int* __restrict__ src,
                  const long long* __restrict__ row_ptr,
                  long long hub_degree, const long long* __restrict__ seg,
                  int n_seg, int seg_blocks, int nr,
                  float* __restrict__ part, T* __restrict__ y) {
  constexpr int RC = Cfg<T>::RC, PL = Cfg<T>::PL;
  __shared__ float res[RC][D + 1];
  const int lane = threadIdx.x & 31;
  const int oct = threadIdx.x / OCT;
  const int sub = threadIdx.x % OCT;
  const unsigned mask = 0xffu << (lane & ~(OCT - 1));
  if ((int)blockIdx.x < seg_blocks) {  // uniform over the block
    const long long j = (long long)blockIdx.x * OCTETS + oct;
    if (j < n_seg) {
      float acc[SUMS][PL] = {};
      walk<T>(s, src, seg[2 * j], seg[2 * j + 1], sub, mask, acc);
      float* p = part + j * RC + sub * PL;
#pragma unroll
      for (int i = 0; i < PL; ++i) p[i] = total(acc, i);
    }
    return;
  }
  const long long v0 = (long long)(blockIdx.x - seg_blocks) * D;
#pragma unroll 1
  for (int d = oct; d < D; d += OCTETS) {
    const long long v = v0 + d;
    float acc[SUMS][PL] = {};
    if (v < n) {  // uniform over the octet
      const long long e0 = row_ptr[v], e1 = row_ptr[v + 1];
      if (e1 - e0 <= hub_degree) walk<T>(s, src, e0, e1, sub, mask, acc);
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) res[sub * PL + i][d] = total(acc, i);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const long long v = v0 + d;
    if (v < n) y[(long long)r * n + v] = rt::from_f32<T>(res[r][d]);
  }
}

// y[r, hub_vertex[h]] = the sum of hub h's segment partials, in order.
template <typename T>
__global__ void hub_kernel(const float* __restrict__ part,
                           const int* __restrict__ hub_vertex,
                           const int* __restrict__ hub_seg_ptr, int nr,
                           long long n, T* __restrict__ y) {
  constexpr int RC = Cfg<T>::RC;
  const int h = blockIdx.x, r = threadIdx.x;
  if (r >= nr) return;
  float acc = 0.f;
  for (int j = hub_seg_ptr[h]; j < hub_seg_ptr[h + 1]; ++j)
    acc += part[(long long)j * RC + r];
  y[(long long)r * n + hub_vertex[h]] = rt::from_f32<T>(acc);
}

template <typename T, int D>
int launch_d(const void* m, int rows, long long n, const int* src,
             const long long* row_ptr, long long hub_degree,
             const long long* seg, int n_seg, const int* hub_vertex,
             const int* hub_seg_ptr, int n_hubs, void* scratch, float* part,
             void* out, cudaStream_t stream) {
  constexpr int RC = Cfg<T>::RC;
  const long long stage_blocks = (n + STAGE_V - 1) / STAGE_V;
  const long long seg_blocks = (n_seg + OCTETS - 1) / OCTETS;
  const long long blocks = seg_blocks + (n + D - 1) / D;
  if (stage_blocks > INT_MAX || blocks > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  T* s = static_cast<T*>(scratch);
  for (int r0 = 0; r0 < rows; r0 += RC) {
    const int nr = rows - r0 < RC ? rows - r0 : RC;
    const T* mc = static_cast<const T*>(m) + (long long)r0 * n;
    T* yc = static_cast<T*>(out) + (long long)r0 * n;
    stage_kernel<T><<<(unsigned)stage_blocks, THREADS, 0, stream>>>(mc, nr, n,
                                                                    s);
    gather_kernel<T, D><<<(unsigned)blocks, THREADS, 0, stream>>>(
        s, n, src, row_ptr, hub_degree, seg, n_seg, (int)seg_blocks, nr, part,
        yc);
    if (n_hubs > 0)
      hub_kernel<T><<<n_hubs, RC, 0, stream>>>(part, hub_vertex, hub_seg_ptr,
                                               nr, n, yc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename T>
int launch(int dests, const void* m, int rows, long long n, const int* src,
           const long long* row_ptr, long long hub_degree,
           const long long* seg, int n_seg, const int* hub_vertex,
           const int* hub_seg_ptr, int n_hubs, void* scratch, float* part,
           void* out, cudaStream_t stream) {
  switch (dests) {
#define RT_DESTS(D)                                                          \
  case D:                                                                    \
    return launch_d<T, D>(m, rows, n, src, row_ptr, hub_degree, seg, n_seg, \
                          hub_vertex, hub_seg_ptr, n_hubs, scratch, part,   \
                          out, stream);
    RT_DESTS(32)
    RT_DESTS(64)
    RT_DESTS(128)
#undef RT_DESTS
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (storage; the sums are f32 either way).
// dests: destinations a gather block holds, 32, 64 or 128 (the default).
// scratch: n * 128 bytes; part: n_seg * (128 / itemsize) floats. Returns
// the first cudaError_t of the launches.
extern "C" int rt_spmm_gather(int dtype, int dests, const void* m, int rows,
                              long long n, const int* src,
                              const long long* row_ptr, long long hub_degree,
                              const long long* seg, int n_seg,
                              const int* hub_vertex, const int* hub_seg_ptr,
                              int n_hubs, void* scratch, void* part, void* out,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch<float>(dests, m, rows, n, src, row_ptr, hub_degree, seg,
                         n_seg, hub_vertex, hub_seg_ptr, n_hubs, scratch, p,
                         out, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dests, m, rows, n, src, row_ptr, hub_degree,
                                 seg, n_seg, hub_vertex, hub_seg_ptr, n_hubs,
                                 scratch, p, out, st);
  return (int)cudaErrorInvalidValue;
}

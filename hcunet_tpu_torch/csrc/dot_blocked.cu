// Blocked dense matrix product with float32 accumulation.
//
//   out[m, n] = sum_k x[m, k] * w[k, n]
//
// x [M, K] row-major (the caller's [B, X, Y, K] with M = B*X*Y), w [K, N]
// row-major, out [M, N] in x's type.  float32 and bfloat16; the sum is
// float32 and is rounded to the output type once.
//
// Replaces the TPU kernel scripts/probe_pallas_dot.py::pallas_dot (body
// _kernel): the control that runs only the dot of the Pallas conv probes, at
// their block geometry, to split a conv kernel's shortfall into the product
// itself and the tap handling.  Here it is the same control beside kernel
// K1 (conv3d_valid.cu): the same tiles, warps and WMMA fragments as K1's
// implicit GEMM, with the im2col gather replaced by a dense A.
//
// Bound on an H100: at the TPU probe's shapes ([12*492*494, 768] x
// [768, 384] and [6*492*494, 2304] x [2304, 128], bf16) the product does
// 256 and 121 flops per byte it must move, below the card's ~295 ridge
// (989 TFLOP/s bf16 over 3.35 TB/s), so both are bound by bytes (~2 ms);
// float32 runs on the FMA units (67 TFLOP/s) and is bound by operations.
//
// Design: each 256-thread block owns a BM x BN output tile and walks K in
// BK slices staged in shared memory; a warp loads 32 consecutive k of one
// row (coalesced).  bfloat16 multiplies on the tensor cores through WMMA
// (mma.sync, 16x16x16, float32 accumulators) and stages the float32 tile
// through shared memory for a coalesced, masked store; float32 runs on the
// FMA units, so a float32 result stays float32 to the last bit (no TF32).
// Ragged M and N edges and K tails (K need not be a multiple of 16) are
// zero-filled in shared memory and masked at the store; offsets are 64-bit
// (the probe's second case reads 3.36e9 elements, past 2^31).  Not yet
// done: TMA loads, wgmma, a multi-stage pipeline, vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BM = 128;       // rows of out per block
constexpr int BK = 32;        // K slice per step
constexpr int NT = 256;       // threads per block
constexpr int A_LD = BK + 8;  // shared row stride of the A tile (elements)

struct DotArgs {
  const void* x;
  const void* w;
  void* y;
  long long M;
  int K;
  int N;
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Load the A and B tiles of one K step into shared memory, zero past the
// edges of M, K and N.
template <typename T, int BN>
__device__ __forceinline__ void load_tiles(const DotArgs& a, const T* __restrict__ x,
                                           const T* __restrict__ w, T* As, T* Bs,
                                           long long m0, int k0, int n0, int tid) {
  constexpr int B_LD = BN + 8;
  constexpr int ROWS_PER_PASS = NT / BK;
  const T zero = from_float<T>(0.f);

  // A: each thread owns one K column of the tile, a warp one row's 32 k.
  const int kk = tid % BK;
  const int k = k0 + kk;
  const bool kvalid = k < a.K;
  T va[BM / ROWS_PER_PASS];
#pragma unroll
  for (int i = 0; i < BM / ROWS_PER_PASS; ++i) {
    const long long m = m0 + tid / BK + i * ROWS_PER_PASS;
    va[i] = (kvalid && m < a.M) ? x[m * a.K + k] : zero;
  }
#pragma unroll
  for (int i = 0; i < BM / ROWS_PER_PASS; ++i) {
    As[(tid / BK + i * ROWS_PER_PASS) * A_LD + kk] = va[i];
  }

#pragma unroll
  for (int e = tid; e < BK * BN; e += NT) {
    const int kr = e / BN;
    const int nc = e % BN;
    const int kg = k0 + kr;
    const int ng = n0 + nc;
    Bs[kr * B_LD + nc] = (kg < a.K && ng < a.N) ? w[(long long)kg * a.N + ng] : zero;
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(NT) dot_blocked_kernel(DotArgs a) {
  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  constexpr int B_LD = BN + 8;
  constexpr int C_LD = BN + 4;
  constexpr int AB_BYTES = (BM * A_LD + BK * B_LD) * (int)sizeof(T);
  constexpr int C_BYTES = kTensorCores ? BM * C_LD * (int)sizeof(float) : 0;
  constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * A_LD;

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  T* __restrict__ y = static_cast<T*>(a.y);
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  if constexpr (kTensorCores) {
    constexpr int WN = BN / 16 >= 2 ? 2 : 1;  // warps along N
    constexpr int WM = (NT / 32) / WN;        // warps along M
    constexpr int FM = BM / WM / 16;          // 16x16 fragments per warp, M
    constexpr int FN = BN / WN / 16;          // 16x16 fragments per warp, N
    const int warp = tid / 32;
    const int wm = warp / WN;
    const int wn = warp % WN;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < a.K; k0 += BK) {
      load_tiles<T, BN>(a, x, w, As, Bs, m0, k0, n0, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * FM * 16 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * FN * 16 + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Epilogue: stage the float32 tile through shared memory for a
    // coalesced, masked store.
    float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(Cs + (wm * FM * 16 + i * 16) * C_LD + wn * FN * 16 + j * 16,
                                acc[i][j], C_LD, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < BM * BN; e += NT) {
      const int r = e / BN;
      const int c = e % BN;
      const long long m = m0 + r;
      const int n = n0 + c;
      if (m < a.M && n < a.N) y[m * a.N + n] = from_float<T>(Cs[r * C_LD + c]);
    }
  } else {
    // float32 on the FMA units: each thread owns TM rows x TN columns,
    // strided by 16 so that a warp reads shared memory without conflicts.
    constexpr int TN = BN / 16;
    constexpr int TM = BM / 16;
    const int tn = tid % 16;
    const int tm = tid / 16;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < a.K; k0 += BK) {
      load_tiles<T, BN>(a, x, w, As, Bs, m0, k0, n0, tid);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float av[TM];
        float bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[(tm + 16 * i) * A_LD + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * B_LD + tn + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + tm + 16 * i;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tn + 16 * j;
        if (n < a.N) y[m * a.N + n] = from_float<T>(acc[i][j]);
      }
    }
  }
}

template <typename T, int BN>
cudaError_t launch(const DotArgs& a, cudaStream_t stream) {
  const long long m_tiles = (a.M + BM - 1) / BM;
  const dim3 grid((unsigned)m_tiles, (unsigned)((a.N + BN - 1) / BN));
  dot_blocked_kernel<T, BN><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const DotArgs& a, cudaStream_t stream) {
  if (a.N <= 16) return launch<T, 16>(a, stream);
  if (a.N <= 32) return launch<T, 32>(a, stream);
  return launch<T, 64>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); a shape the grid cannot hold returns
// cudaErrorInvalidValue without launching.
extern "C" int dot_blocked(int dtype, const void* x, const void* w, void* y, long long M,
                           int K, int N, void* stream) {
  DotArgs a;
  a.x = x;
  a.w = w;
  a.y = y;
  a.M = M;
  a.K = K;
  a.N = N;
  if (M <= 0 || K < 0 || N <= 0 || (M + BM - 1) / BM > 0x7fffffffLL ||
      (N + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
  return (int)err;
}

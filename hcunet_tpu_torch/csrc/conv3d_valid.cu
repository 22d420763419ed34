// Valid 3D convolution, channels-last, with bias and optional ReLU.
//
//   out[b,x,y,z,co] = act(bias[co] + sum_{dx,dy,dz,ci}
//                         in[b, x+dx*dil_x, y+dy*dil_y, z+dz*dil_z, ci]
//                         * W[dx,dy,dz,ci,co])
//
// in  [B, X, Y, Z, Cin], W [kx, ky, kz, Cin, Cout] (= a row-major [K, Cout]
// matrix with K = kx*ky*kz*Cin), bias [Cout] float32, out [B, Xo, Yo, Zo, Cout]
// in the input's type.  float32 and bfloat16 inputs; the sum is float32.
//
// Replaces the TPU kernels scripts/probe_pallas_conv.py::pallas_conv_packed
// (per-tap dots into an f32 scratch), ::pallas_conv_im2col (one im2col dot
// per block) and ::pallas_conv_gsum (lane-concatenated taps, ky shifted
// adds).  All three compute this function on a z-block-packed layout, which
// is itself a valid 3D conv, so this one kernel covers them and the port's
// unpacked serving convs alike.
//
// Bound on an H100: a conv does 2*K*Cout flops per output voxel for about
// 2*(Cin+Cout) bytes of bf16 input and output.  The H100's ridge is ~295
// flops per byte (989 TFLOP/s bf16 over 3.35 TB/s), so the serving U-Net's
// 16- and 32-channel levels (58-192 flops/byte) and the 1x1 output conv are
// bound by bytes, and its 64- and 128-channel levels (288-768) by the
// tensor cores' operations.  float32 runs on the FMA units (67 TFLOP/s), so
// every float32 conv is bound by operations.
//
// Design: a plain implicit GEMM.  M = output voxels, N = Cout, K = taps*Cin.
// Each 256-thread block owns a BM x BN output tile.  Per K step it gathers a
// BM x BK slice of the (never materialised) im2col matrix straight from the
// input through per-row base offsets and a per-column tap offset, and the
// matching BK x BN weight slice, into shared memory.  bfloat16 multiplies on
// the tensor cores through WMMA (mma.sync, 16x16x16, float32 accumulators);
// float32 runs on the FMA units, so a float32 result stays float32 to the
// last bit (no TF32).  Bias and ReLU sit in the epilogue.  Ragged M and N
// edges and K tails are masked in the kernel; offsets are 64-bit because
// activations reach ~8e8 elements.  The N tile follows Cout (16, 32 or 64)
// so the 16-channel first level wastes no tensor-core work.  Not yet done:
// TMA loads, wgmma, a multi-stage pipeline, vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BM = 128;        // output voxels per block
constexpr int BK = 32;         // K slice per step
constexpr int NT = 256;        // threads per block
constexpr int A_LD = BK + 8;   // shared row stride of the A tile (elements)

struct ConvArgs {
  const void* x;
  const void* w;
  const float* bias;
  void* y;
  long long M;  // B * Xo * Yo * Zo
  int X, Y, Z, Cin;
  int Xo, Yo, Zo, Cout;
  int kx, ky, kz;
  int dil_x, dil_y, dil_z;
  int K;  // kx * ky * kz * Cin
  int relu;
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Gather the A (im2col) and B (weight) tiles of one K step into shared memory.
template <typename T, int BN>
__device__ __forceinline__ void load_tiles(const ConvArgs& a, const T* __restrict__ x,
                                           const T* __restrict__ w, T* As, T* Bs,
                                           const long long* row_base, int k0, int n0,
                                           int tid) {
  constexpr int B_LD = BN + 8;
  constexpr int ROWS_PER_PASS = NT / BK;
  const T zero = from_float<T>(0.f);

  // A: each thread owns one K column of the tile; its tap offset is shared
  // by all the rows it loads.
  const int kk = tid % BK;
  const int k = k0 + kk;
  const bool kvalid = k < a.K;
  long long koff = 0;
  if (kvalid) {
    const int tap = k / a.Cin;
    const int ci = k - tap * a.Cin;
    const int dz = tap % a.kz;
    const int t2 = tap / a.kz;
    const int dy = t2 % a.ky;
    const int dx = t2 / a.ky;
    koff = (((long long)dx * a.dil_x * a.Y + (long long)dy * a.dil_y) * a.Z +
            (long long)dz * a.dil_z) * a.Cin + ci;
  }
  T va[BM / ROWS_PER_PASS];
#pragma unroll
  for (int i = 0; i < BM / ROWS_PER_PASS; ++i) {
    const long long base = row_base[tid / BK + i * ROWS_PER_PASS];
    va[i] = (kvalid && base >= 0) ? x[base + koff] : zero;
  }
#pragma unroll
  for (int i = 0; i < BM / ROWS_PER_PASS; ++i) {
    As[(tid / BK + i * ROWS_PER_PASS) * A_LD + kk] = va[i];
  }

  // B: the weights are already a row-major [K, Cout] matrix.
#pragma unroll
  for (int e = tid; e < BK * BN; e += NT) {
    const int kr = e / BN;
    const int nc = e % BN;
    const int kg = k0 + kr;
    const int ng = n0 + nc;
    Bs[kr * B_LD + nc] =
        (kg < a.K && ng < a.Cout) ? w[(long long)kg * a.Cout + ng] : zero;
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(NT) conv3d_valid_kernel(ConvArgs a) {
  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  constexpr int B_LD = BN + 8;
  constexpr int C_LD = BN + 4;
  constexpr int AB_BYTES = (BM * A_LD + BK * B_LD) * (int)sizeof(T);
  constexpr int C_BYTES = kTensorCores ? BM * C_LD * (int)sizeof(float) : 0;
  constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ long long row_base[BM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + BM * A_LD;

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  T* __restrict__ y = static_cast<T*>(a.y);
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Offset of input voxel (b, xo, yo, zo), channel 0, for each output row;
  // -1 marks rows past M.
  for (int r = tid; r < BM; r += NT) {
    const long long m = m0 + r;
    long long base = -1;
    if (m < a.M) {
      long long t = m;
      const int zo = (int)(t % a.Zo);
      t /= a.Zo;
      const int yo = (int)(t % a.Yo);
      t /= a.Yo;
      const int xo = (int)(t % a.Xo);
      const long long b = t / a.Xo;
      base = (((b * a.X + xo) * a.Y + yo) * (long long)a.Z + zo) * a.Cin;
    }
    row_base[r] = base;
  }
  __syncthreads();

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
      load_tiles<T, BN>(a, x, w, As, Bs, row_base, k0, n0, tid);
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

    // Epilogue: stage the float32 tile through shared memory so that the
    // bias, ReLU and the masked store run with coalesced writes.
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
      if (m < a.M && n < a.Cout) {
        float v = Cs[r * C_LD + c] + a.bias[n];
        if (a.relu) v = fmaxf(v, 0.f);
        y[m * a.Cout + n] = from_float<T>(v);
      }
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
      load_tiles<T, BN>(a, x, w, As, Bs, row_base, k0, n0, tid);
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
        if (n < a.Cout) {
          float v = acc[i][j] + a.bias[n];
          if (a.relu) v = fmaxf(v, 0.f);
          y[m * a.Cout + n] = from_float<T>(v);
        }
      }
    }
  }
}

template <typename T, int BN>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  const long long m_tiles = (a.M + BM - 1) / BM;
  const dim3 grid((unsigned)m_tiles, (unsigned)((a.Cout + BN - 1) / BN));
  conv3d_valid_kernel<T, BN><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const ConvArgs& a, cudaStream_t stream) {
  if (a.Cout <= 16) return launch<T, 16>(a, stream);
  if (a.Cout <= 32) return launch<T, 32>(a, stream);
  return launch<T, 64>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); a grid too large for one launch returns
// cudaErrorInvalidValue without launching.
extern "C" int conv3d_valid(int dtype, const void* x, const void* w, const float* bias,
                            void* y, int B, int X, int Y, int Z, int Cin, int kx, int ky,
                            int kz, int dil_x, int dil_y, int dil_z, int Cout, int relu,
                            void* stream) {
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.y = y;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  a.Cin = Cin;
  a.kx = kx;
  a.ky = ky;
  a.kz = kz;
  a.dil_x = dil_x;
  a.dil_y = dil_y;
  a.dil_z = dil_z;
  a.Xo = X - dil_x * (kx - 1);
  a.Yo = Y - dil_y * (ky - 1);
  a.Zo = Z - dil_z * (kz - 1);
  a.Cout = Cout;
  a.K = kx * ky * kz * Cin;
  a.relu = relu;
  a.M = (long long)B * a.Xo * a.Yo * a.Zo;
  if (a.M <= 0 || Cout <= 0 || (a.M + BM - 1) / BM > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
  return (int)err;
}

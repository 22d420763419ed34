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
// Both paths are implicit GEMMs: M = output voxels, N = Cout, K = taps*Cin
// (tap-major, Cin fastest, as W's [K, Cout] rows), with per-row input base
// offsets and a per-K tap offset standing in for the never-materialised
// im2col matrix.  Bias and ReLU sit in the epilogue; ragged M and N edges
// and K tails are masked in the kernel; offsets are 64-bit because
// activations reach ~8e8 elements.  conv3d_valid_route() picks the path
// from (dtype, Cin, Cout) alone:
//
// The ring path, bfloat16 with Cin % 8 == 0 (every serving layer but the
// 4-channel first one).  A 16-byte chunk of a row's K slice is then 8
// channels of one tap, contiguous in the input, so every thread of the
// block issues 16-byte cp.async copies (zero-filled past M and K) into a
// 3-stage ring in dynamic shared memory while the tensor cores work on an
// earlier stage: one __syncthreads per 64-deep K stage.  A thread copies
// the same K chunk of the same rows in every stage; their input offsets
// stay in registers and its tap advances by adds (the host divides once).
// The tiles are stored as wgmma's no-swizzle core matrices (8 rows x 16
// bytes): A [BM x 64] K-major, the weights [64 x BN] MN-major as W already
// is.  Each warpgroup runs wgmma.mma_async m64nBNk16 on its 64 rows, BN =
// 16, 32, 64 or 128 following Cout, with float32 accumulators in registers;
// the epilogue adds the bias, applies the ReLU and stores bf16 pairs
// straight from them.  Blocks hold 256 rows (four warpgroups) when K >= 256
// and Cout <= 64, else 128.  The input is copied through L1
// (cp.async.ca): a block's rows re-read each other's voxels across the z and
// y taps; the weights too when all of W is at most 8 KB.
//
// What bounds each layer here: the bytes for Cin and Cout <= 32 and the
// 1x1 output conv, the tensor cores for 64 and 128 channels; but the im2col
// gather re-reads every input voxel once per tap (18x for the 3x3x2
// kernels) from L1 or L2, and on the deep up-path convs (up0-up2.conv1)
// that L2 traffic, not the bound, sets the time.  Not yet done: an input
// halo staged once per block, TMA loads, the 128-byte swizzle, a producer
// warp and persistent blocks.
//
// The basic path, float32, and bfloat16 with any other Cin (the 4-channel
// first layer): each 256-thread block owns a BM x BN tile and gathers a
// BM x 32 A slice element by element, and the matching weights, into
// shared memory per K step.  bfloat16 multiplies through WMMA (mma.sync,
// 16x16x16, float32 accumulators); float32 runs on the FMA units, so a
// float32 result stays float32 to the last bit (no TF32).  The N tile
// follows Cout (16, 32 or 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "hopper_mma.cuh"

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

// Offset of input voxel (b, xo, yo, zo), channel 0, of output row m < M.
__device__ __forceinline__ long long input_row_base(const ConvArgs& a, long long m) {
  long long t = m;
  const int zo = (int)(t % a.Zo);
  t /= a.Zo;
  const int yo = (int)(t % a.Yo);
  t /= a.Yo;
  const int xo = (int)(t % a.Xo);
  const long long b = t / a.Xo;
  return (((b * a.X + xo) * a.Y + yo) * (long long)a.Z + zo) * a.Cin;
}

// Offset of K column k < K (tap (dx, dy, dz), channel ci) from a row's base.
__device__ __forceinline__ long long tap_offset(const ConvArgs& a, int k) {
  const int tap = k / a.Cin;
  const int ci = k - tap * a.Cin;
  const int dz = tap % a.kz;
  const int t2 = tap / a.kz;
  const int dy = t2 % a.ky;
  const int dx = t2 / a.ky;
  return (((long long)dx * a.dil_x * a.Y + (long long)dy * a.dil_y) * a.Z +
          (long long)dz * a.dil_z) * a.Cin + ci;
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
  const long long koff = kvalid ? tap_offset(a, k) : 0;
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
    row_base[r] = m < a.M ? input_row_base(a, m) : -1;
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

// ---------------------------------------------------------------------------
// The ring path: bfloat16, Cin % 8 == 0.

namespace ring {

constexpr int BK = 64;                // K per stage: four wgmma k16 steps
constexpr int CH = BK / 8;            // 16-byte chunks of a row's K slice
constexpr int CORE = 128;             // bytes of one 8 x 16-byte core matrix
// weights of at most this many bytes are copied through L1 (every block
// re-reads all of them); larger ones only through L2, where they would evict
// the input rows the blocks share
constexpr long long B_CA_MAX = 8192;

// n / d for n < 2^31 by a multiply-high and a shift, with the multiplier
// found on the host (d >= 1)
struct FastDiv {
  uint32_t d, mul, shift;
  void init(uint32_t divisor) {
    d = divisor;
    uint32_t log2 = 0;
    while ((1ull << log2) < divisor) ++log2;
    if (divisor == 1) {
      mul = 0;
      shift = 0;
    } else {
      const uint32_t p = 31 + log2;
      mul = (uint32_t)(((1ull << p) + divisor - 1) / divisor);
      shift = p - 32;
    }
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shift;
  }
};

// A thread's K chunk: the input offset of K column k = 8 chunk + 64 s
// (tap (dx, dy, dz), channel ci) for stage s = 0, 1, ..., advanced by adds.
// The host sets the state of each chunk at s = 0.
struct TapWalk {
  long long tap_base;  // offset of tap (dx, dy, dz), channel 0
  int ci, dz, dy;
};

struct RingArgs {
  ConvArgs a;
  FastDiv zo, yo, xo;  // row m -> (b, xo, yo, zo), used when M < 2^31
  TapWalk walk[CH];
  int b_ca;  // copy the weights through L1: the whole of W fits
};

template <int BM, int BN>
struct Tile {
  static constexpr int NT = 2 * BM;  // one warpgroup per 64 rows
  static constexpr int STAGES = 3;
  static constexpr int NCH = BN / 8;  // 16-byte chunks of one weight row
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ void advance(TapWalk& t, const ConvArgs& a) {
  t.ci += BK;
  while (t.ci >= a.Cin) {
    t.ci -= a.Cin;
    t.tap_base += (long long)a.dil_z * a.Cin;
    if (++t.dz == a.kz) {
      t.dz = 0;
      t.tap_base += ((long long)a.dil_y * a.Z - (long long)a.kz * a.dil_z) * a.Cin;
      if (++t.dy == a.ky) {
        t.dy = 0;
        t.tap_base += ((long long)a.dil_x * a.Y - (long long)a.ky * a.dil_y) * a.Z * a.Cin;
      }
    }
  }
}

template <int BM, int BN, bool kVecB>
__global__ void __launch_bounds__(2 * BM)
    conv3d_valid_ring_kernel(const __grid_constant__ RingArgs r) {
  using Tl = Tile<BM, BN>;
  constexpr int NT = Tl::NT;
  constexpr int STAGES = Tl::STAGES;
  constexpr int NCH = Tl::NCH;
  constexpr int A_PER_THREAD = BM * CH / NT;
  const ConvArgs& a = r.a;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long row_base[BM];
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* __restrict__ w = static_cast<const __nv_bfloat16*>(a.w);
  __nv_bfloat16* __restrict__ y = static_cast<__nv_bfloat16*>(a.y);
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const uint32_t ring0 = hopper::smem_addr(smem);

  // each row's input offset, once per row (-1: past M)
  if (tid < BM) {
    const long long m = m0 + tid;
    long long base = -1;
    if (m < a.M && a.M < (1LL << 31)) {
      const uint32_t t0 = (uint32_t)m;
      const uint32_t t1 = r.zo.div(t0);
      const uint32_t t2 = r.yo.div(t1);
      const uint32_t b = r.xo.div(t2);
      base = ((((long long)b * a.X + (t2 - b * a.Xo)) * a.Y + (t1 - t2 * a.Yo)) * a.Z +
              (t0 - t1 * a.Zo)) * (long long)a.Cin;
    } else if (m < a.M) {
      base = input_row_base(a, m);
    }
    row_base[tid] = base;
  }
  __syncthreads();

  // Byte 16 q of a stage's A tile is row 8 (q / 8 / CH) + q % 8, K chunk
  // (q / 8) % CH: core matrix (row / 8, chunk) at (row / 8 * CH + chunk) *
  // 128.  Thread tid copies q = tid + NT i, so its K chunk is the same in
  // every stage and its rows are fixed: their offsets stay in registers.
  const int chunk = (tid >> 3) % CH;
  long long rbase[A_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    rbase[i] = row_base[((tid >> 3) / CH + i * (NT / 8 / CH)) * 8 + (tid & 7)];
  }
  TapWalk walk = r.walk[chunk];

  // Issue the copies of K stage kt (the next one in order) into ring slot
  // kt % STAGES.
  auto load_stage = [&](int kt) {
    const uint32_t sa = ring0 + (kt % STAGES) * Tl::STAGE_BYTES;
    const bool kvalid = kt * BK + chunk * 8 < a.K;
    const long long koff = walk.tap_base + walk.ci;
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const bool ok = kvalid && rbase[i] >= 0;
      hopper::cp_async16_ca(sa + (tid + NT * i) * 16, ok ? x + rbase[i] + koff : x, ok ? 16 : 0);
    }
    advance(walk, a);
    // Byte 16 q of the B tile is K row 8 (q / 8 / NCH) + q % 8, n chunk
    // (q / 8) % NCH: core matrix (k / 8, n / 8) at (k / 8 * NCH + n / 8) *
    // 128, rows of 8 consecutive n as W holds them.
    const uint32_t sb = sa + Tl::A_BYTES;
#pragma unroll
    for (int i = 0; i < (BK * NCH + NT - 1) / NT; ++i) {
      const int q = tid + NT * i;
      if (q >= BK * NCH) break;
      const int kg = kt * BK + (q >> 3) / NCH * 8 + (q & 7);
      const int ng = n0 + (q >> 3) % NCH * 8;
      const __nv_bfloat16* src = w + (long long)kg * a.Cout + ng;
      if constexpr (kVecB) {
        const bool ok = kg < a.K && ng < a.Cout;
        if (r.b_ca) {
          hopper::cp_async16_ca(sb + q * 16, ok ? src : w, ok ? 16 : 0);
        } else {
          hopper::cp_async16_cg(sb + q * 16, ok ? src : w, ok ? 16 : 0);
        }
      } else {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem + (sb - ring0) + q * 16);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dst[e] = (kg < a.K && ng + e < a.Cout) ? src[e] : __float2bfloat16(0.f);
        }
      }
    }
  };

  const int KT = (a.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s);
    hopper::cp_async_commit();
  }

  // Consumer: warpgroup wg owns rows 64 wg .. 64 wg + 63 and all BN columns.
  const int wg = tid >> 7;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    // stage kt has landed for every thread, and every thread is done with
    // stage kt - 1, whose slot the next copies refill
    hopper::cp_async_wait<STAGES - 2>();
    hopper::fence_proxy_async();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load_stage(kt + STAGES - 1);
    hopper::cp_async_commit();

    const uint32_t sa = ring0 + (kt % STAGES) * Tl::STAGE_BYTES;
    const uint32_t sb = sa + Tl::A_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A: row groups 8 wg .. 8 wg + 7, K chunks 2 ks and 2 ks + 1 (LBO: the
      // next chunk, SBO: the next row group); B: K row groups 2 ks and
      // 2 ks + 1 (LBO), all NCH n chunks (SBO)
      const uint64_t da =
          hopper::desc_noswizzle(sa + (8 * wg * CH + 2 * ks) * CORE, CORE, CH * CORE);
      const uint64_t db = hopper::desc_noswizzle(sb + 2 * ks * NCH * CORE, NCH * CORE, CORE);
      hopper::Wgmma<BN>::mma(acc, da, db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) hopper::fence_operand(acc[i]);
  }

  // Epilogue from the accumulators: d[4j + 2h + e] of thread tl of the
  // warpgroup is row 16 (tl / 32) + (tl % 32) / 4 + 8h, column
  // 8j + 2 (tl % 4) + e.  Bias, ReLU, bf16 pairs.
  const int tl = tid & 127;
  const long long row = m0 + wg * 64 + (tl >> 5) * 16 + ((tl & 31) >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (tl & 3);
    if (n >= a.Cout) continue;
    const bool pair = n + 1 < a.Cout;
    const float b0 = a.bias[n];
    const float b1 = pair ? a.bias[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = row + 8 * h;
      if (m >= a.M) continue;
      float v0 = acc[4 * j + 2 * h] + b0;
      float v1 = acc[4 * j + 2 * h + 1] + b1;
      if (a.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      __nv_bfloat16* dst = y + m * a.Cout + n;
      if (pair && (a.Cout & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16(v0);
        if (pair) dst[1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int BM, int BN, bool kVecB>
cudaError_t launch(const RingArgs& r, cudaStream_t stream) {
  using Tl = Tile<BM, BN>;
  auto* kernel = conv3d_valid_ring_kernel<BM, BN, kVecB>;
  // above 48 KB of dynamic shared memory a kernel must opt in; the
  // attribute belongs to the current device, so it is set on every launch
  // (a host call of about a microsecond)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long m_tiles = (r.a.M + BM - 1) / BM;
  const dim3 grid((unsigned)m_tiles, (unsigned)((r.a.Cout + BN - 1) / BN));
  kernel<<<grid, Tl::NT, Tl::SMEM_BYTES, stream>>>(r);
  return cudaGetLastError();
}

// weights are copied 16 bytes at a time when every row starts 16-byte
// aligned (Cout % 8 == 0), element by element otherwise
template <int BM, int BN>
cudaError_t launch_bn(const RingArgs& r, cudaStream_t stream) {
  return r.a.Cout % 8 == 0 ? launch<BM, BN, true>(r, stream) : launch<BM, BN, false>(r, stream);
}

cudaError_t dispatch(const ConvArgs& a, cudaStream_t stream) {
  RingArgs r;
  r.a = a;
  r.zo.init(a.Zo);
  r.yo.init(a.Yo);
  r.xo.init(a.Xo);
  for (int c = 0; c < CH; ++c) {
    const int tap = 8 * c / a.Cin;
    TapWalk& t = r.walk[c];
    t.ci = 8 * c - tap * a.Cin;
    t.dz = tap % a.kz;
    t.dy = tap / a.kz % a.ky;
    const int dx = tap / a.kz / a.ky;
    t.tap_base = (((long long)dx * a.dil_x * a.Y + (long long)t.dy * a.dil_y) * a.Z +
                  (long long)t.dz * a.dil_z) * a.Cin;
  }
  r.b_ca = (long long)a.K * a.Cout * 2 <= B_CA_MAX;
  // 256-row blocks (four warpgroups) halve the weight copies and the
  // per-block set-up per row where K is deep enough to amortise a longer
  // pipeline fill; N = 128 keeps two warpgroups (64 accumulators each)
  if (a.Cout > 64) return launch_bn<128, 128>(r, stream);
  if (a.K >= 256) {
    if (a.Cout <= 16) return launch_bn<256, 16>(r, stream);
    if (a.Cout <= 32) return launch_bn<256, 32>(r, stream);
    return launch_bn<256, 64>(r, stream);
  }
  if (a.Cout <= 16) return launch_bn<128, 16>(r, stream);
  if (a.Cout <= 32) return launch_bn<128, 32>(r, stream);
  return launch_bn<128, 64>(r, stream);
}

}  // namespace ring

}  // namespace

// The path of a call: 1 = the ring path (bfloat16, Cin % 8 == 0), 0 = the
// basic path.
extern "C" int conv3d_valid_route(int dtype, int Cin, int Cout) {
  (void)Cout;
  return dtype == 1 && Cin % 8 == 0 ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); a grid too large for one launch returns
// cudaErrorInvalidValue, and x or w not 16-byte aligned on the ring path
// cudaErrorMisalignedAddress, without launching.
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
  if (conv3d_valid_route(dtype, Cin, Cout) == 1) {
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) {
      return (int)cudaErrorMisalignedAddress;
    }
    return (int)ring::dispatch(a, s);
  }
  cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
  return (int)err;
}

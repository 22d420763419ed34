// Blocked dense matrix product with float32 accumulation.
//
//   out[m, n] = sum_k x[m, k] * w[k, n]
//
// x [M, K] row-major (the caller's [B, X, Y, K] with M = B*X*Y), w [K, N]
// row-major, out [M, N] in x's type.  float32 and bfloat16; the sum is
// float32 and is rounded to the output type once.
//
// Replaces the TPU kernel scripts/probe_pallas_dot.py::pallas_dot (body
// _kernel), which the TPU defines for bfloat16 only: the control that runs
// only the dot of the Pallas conv probes, to split a conv kernel's
// shortfall into the product itself and the tap handling.  Here it is the
// same control beside kernel K1 (conv3d_valid.cu), and the dense-A test bed
// of K1's wgmma mainloop.
//
// Bound on an H100, bf16: at the TPU probe's shapes the product must move
// 6.72 GB ([12*492*494, 768] x [768, 384]: 2.006 ms at 3.35 TB/s, against
// 1.739 ms of tensor-core operations at 989 TFLOP/s) and 7.09 GB
// ([6*492*494, 2304] x [2304, 128]: 2.118 ms, against 0.870 ms), so both
// are bound by bytes, A's most of all (4.48 and 6.72 GB).  float32 runs on
// the FMA units (67 TFLOP/s) and is bound by operations.
//
// dot_blocked_route() picks the path from (dtype, K, N) alone:
//
// The ring path, bfloat16 with K % 8 == 0 and N % 8 == 0, so that every row
// of x, w and out is whole 16-byte chunks (TMA's global strides and the
// epilogue's stores need them).  What it does about the bound:
// - A leaves device memory once.  Up to N = 256 a block owns all N columns
//   of its row tile (128 x 64 or, where K <= 256, 256 x 64; 128 x 128,
//   192 x 192 or 128 x 256; the columns past N are zeros); wider N takes
//   192-column tiles, those of one row tile walked next to each other, so
//   that the second read of each A stage hits L2.  B (at most 576 KB at the
//   probe's shapes) stays in L2.
// - The copies never wait for the tensor cores.  One thread of a producer
//   warpgroup issues TMA loads (a BM x 64 box of A, 64 x 64 boxes of w, all
//   with the 128-byte swizzle, zeros past M, K and N) into a ring of 3 to 8
//   stages in dynamic shared memory, each stage with a full and an empty
//   mbarrier; two to four consumer warpgroups (64 rows each, the registers
//   moved to them by setmaxnreg) run wgmma.mma_async m64nBNk16 on a stage as
//   soon as it lands, keep one stage's products in flight, and hand the slot
//   back when they are done.
// - Blocks are persistent, one per SM, and walk the tiles, so that a tile's
//   epilogue overlaps the loads of the next: it rounds each float32 sum to
//   bf16 once, stages the warpgroup's rows in shared memory and stores them
//   16 bytes at a time, masked by whole 8-column chunks.
//
// The basic path, float32, and bfloat16 with K or N not a multiple of 8
// (the layer GEMM of the 1x1 output conv, N = 1): each 256-thread block owns
// a 128 x BN tile (BN = 16, 32 or 64) and walks K in 32-wide slices staged
// in shared memory by 2-byte loads; bfloat16 multiplies through WMMA
// (mma.sync, 16x16x16) and stages the float32 tile through shared memory for
// a masked store; float32 runs on the FMA units, so a float32 result stays
// float32 to the last bit (no TF32).  Ragged edges are zero-filled and
// masked.  On both paths offsets are 64-bit (a layer GEMM's A slice holds
// up to 2^31 elements, the second probe 3.36e9).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "hopper_tma.cuh"

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

// ---------------------------------------------------------------------------
// The ring path: bfloat16, K % 8 == 0 and N % 8 == 0.

namespace ring {

constexpr int BK = 64;  // K per stage: four wgmma k16 steps, one 128-byte swizzled row

// Every stage is a BM x 64 A box and BN / 64 boxes of 64 k x 64 n of B,
// all with the 128-byte swizzle.  Warpgroup 0 is the producer (one thread
// issues the TMA loads), warpgroups 1 .. BM / 64 the consumers (64 rows
// each).  The registers go to the consumers (setmaxnreg).
template <int BM_, int BN>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int CW = BM / 64;  // consumer warpgroups
  static constexpr int NT = 128 * (1 + CW);
  // setmaxnreg moves registers within the block's launch allocation (NT x
  // the registers per thread that __launch_bounds__ leaves): the consumers
  // can take what the producer gives up, and no more
  static constexpr int LAUNCH_REGS = 65536 / NT / 8 * 8;
  static constexpr int PRODUCER_REGS = CW > 2 ? 24 : 40;
  static constexpr int CONSUMER_REGS_FIT =
      (NT * LAUNCH_REGS - 128 * PRODUCER_REGS) / (128 * CW) / 8 * 8;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_FIT > 232 ? 232 : CONSUMER_REGS_FIT;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int C_LD = BN * 2 + 16;  // a consumer's staged output row
  static constexpr int C_BYTES = 64 * C_LD;
  static constexpr int BAR_BYTES = 2 * 8 * 8;  // a full and an empty barrier per stage
  // 1 KB of slack to align the ring to the swizzle's 1024-byte atoms; as
  // many stages (at most 8) as fit in the rest beside the output tiles
  static constexpr int STAGES_FIT = (232448 - 1024 - BAR_BYTES - CW * C_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT > 8 ? 8 : STAGES_FIT;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + CW * C_BYTES + BAR_BYTES;
  static_assert(STAGES >= 2, "no room for a ring");
};

struct RingArgs {
  __nv_bfloat16* y;
  long long M;
  int K, N;
  int n_tiles;      // BN-wide column tiles
  long long tiles;  // row tiles x column tiles, the column tile fastest
};

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::NT, 1)
    dot_ring_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const __grid_constant__ RingArgs a) {
  using Tl = Tile<BM, BN>;
  constexpr int STAGES = Tl::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring0 = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (ring0 - raw);
  const uint32_t c0 = ring0 + STAGES * Tl::STAGE_BYTES;  // the consumers' output tiles
  const uint32_t bar0 = c0 + Tl::CW * Tl::C_BYTES;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };
  const int KT = (a.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);            // the producer's expect_tx
      hopper::mbar_init(empty(s), 4 * Tl::CW);  // one arrival per consumer warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps up to STAGES stages in flight, walking the
    // same tiles as the consumers
    hopper::setmaxnreg_dec<Tl::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const int m0 = (int)(t / a.n_tiles) * Tl::BM;
        const int n0 = (int)(t % a.n_tiles) * BN;
        for (int kt = 0; kt < KT; ++kt) {
          hopper::mbar_wait(empty(s), phase ^ 1);
          hopper::mbar_arrive_expect_tx(full(s), Tl::STAGE_BYTES);
          const uint32_t sa = ring0 + s * Tl::STAGE_BYTES;
          hopper::tma_load_2d(sa, &map_a, full(s), kt * BK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            hopper::tma_load_2d(sa + Tl::A_BYTES + j * 8192, &map_b, full(s), n0 + 64 * j, kt * BK);
          }
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<Tl::CONSUMER_REGS>();
    const int cw = (threadIdx.x >> 7) - 1;  // rows 64 cw .. 64 cw + 63 of a tile
    const int tl = threadIdx.x & 127;
    const bool warp_leader = (tl & 31) == 0;
    const uint32_t cst = c0 + cw * Tl::C_BYTES;
    unsigned char* cst_ptr = smem + (cst - ring0);
    int s = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const long long m0 = t / a.n_tiles * Tl::BM;
      const int n0 = (int)(t % a.n_tiles) * BN;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < KT; ++kt) {
        hopper::mbar_wait(full(s), phase);
        const uint32_t sa = ring0 + s * Tl::STAGE_BYTES + cw * 64 * 128;
        const uint32_t sb = ring0 + s * Tl::STAGE_BYTES + Tl::A_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          const uint64_t da = hopper::desc_swizzle128(sa + 32 * ks, 16, 1024);
          const uint64_t db = hopper::desc_swizzle128(sb + 2048 * ks, 8192, 1024);
          hopper::Wgmma<BN>::mma(acc, da, db, 1);
        }
        hopper::wgmma_commit();
        // the previous stage's products are done: hand its slot back
        hopper::wgmma_wait<1>();
        if (prev >= 0 && warp_leader) hopper::mbar_arrive(empty(prev));
        prev = s;
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      if (prev >= 0 && warp_leader) hopper::mbar_arrive(empty(prev));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) hopper::fence_operand(acc[i]);

      // Epilogue, while the producer fills the ring for the next tile:
      // round each sum to bf16 once, stage this warpgroup's 64 rows, store
      // them 16 bytes at a time masked by whole 8-column chunks.
      // d[4j + 2h + e] of thread tl is row 16 (tl / 32) + (tl % 32) / 4 +
      // 8h, column 8j + 2 (tl % 4) + e.
      hopper::named_barrier(1 + cw, 128);  // the last tile's stores are done
      const int r0 = (tl >> 5) * 16 + ((tl & 31) >> 2);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<__nv_bfloat162*>(cst_ptr + (r0 + 8 * h) * Tl::C_LD +
                                             (8 * j + 2 * (tl & 3)) * 2) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      hopper::named_barrier(1 + cw, 128);
      constexpr int NCH = BN / 8;
#pragma unroll 4
      for (int e = tl; e < 64 * NCH; e += 128) {
        const int r = e / NCH;
        const int c = e % NCH;
        const long long m = m0 + cw * 64 + r;
        const int n = n0 + 8 * c;
        if (m < a.M && n < a.N) {
          *reinterpret_cast<uint4*>(a.y + m * a.N + n) =
              *reinterpret_cast<const uint4*>(cst_ptr + r * Tl::C_LD + 16 * c);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver at run time (the library links
// only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2D bf16 tensor map over a row-major [rows, cols] matrix, boxes of
// box_cols x box_rows, 128-byte swizzle, zeros outside.
cudaError_t tensor_map_2d(CUtensorMap* map, const void* base, long long rows, int cols,
                          int box_cols, int box_rows, CUtensorMapL2promotion promotion) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BM, int BN>
cudaError_t launch(const void* x, const void* w, RingArgs a, cudaStream_t stream) {
  using Tl = Tile<BM, BN>;
  const long long m_tiles = (a.M + BM - 1) / BM;
  if (m_tiles * BM > 0x7fffffffLL) return cudaErrorInvalidValue;  // TMA rows are int32
  a.tiles = m_tiles * a.n_tiles;
  CUtensorMap map_a, map_b;
  cudaError_t err = tensor_map_2d(&map_a, x, a.M, a.K, BK, BM, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&map_b, w, a.K, a.N, 64, BK, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (err != cudaSuccess) return err;
  auto* kernel = dot_ring_kernel<BM, BN>;
  // above 48 KB of dynamic shared memory a kernel must opt in; the
  // attribute belongs to the current device, so it is set on every launch
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM_BYTES);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // persistent: one block per SM (or per tile, when there are fewer)
  const long long grid = a.tiles < sms ? a.tiles : sms;
  kernel<<<(unsigned)grid, Tl::NT, Tl::SMEM_BYTES, stream>>>(map_a, map_b, a);
  return cudaGetLastError();
}

// A block owns all N columns of its row tile up to N = 256, so that A
// leaves device memory once; wider N takes 192-column tiles, those of one
// row tile next to each other in the walk, so that the second read of each
// A stage hits L2.  N = 16 to 64 run in a 64-wide tile (zeros past N): those
// products are bound by bytes, and the wasted tensor work costs nothing.
// Where K is short (the 3x3x1 and 3x3x2 layers of 4 to 16 channels) a
// 128-row tile has too little work to hide its fixed cost (pipeline fill,
// epilogue), and 256-row tiles halve the tiles.
cudaError_t dispatch(const void* x, const void* w, RingArgs a, cudaStream_t stream) {
  if (a.K == 0) {  // no product to take: zeros (a tensor map needs K > 0)
    return cudaMemsetAsync(a.y, 0, (size_t)a.M * a.N * 2, stream);
  }
  a.n_tiles = 1;
  if (a.N <= 64 && a.K <= 256) return launch<256, 64>(x, w, a, stream);
  if (a.N <= 64) return launch<128, 64>(x, w, a, stream);
  if (a.N <= 128) return launch<128, 128>(x, w, a, stream);
  if (a.N <= 192) return launch<192, 192>(x, w, a, stream);
  if (a.N <= 256) return launch<128, 256>(x, w, a, stream);
  a.n_tiles = (a.N + 191) / 192;
  return launch<192, 192>(x, w, a, stream);
}

}  // namespace ring

}  // namespace

// The path of a call: 1 = the ring path (bfloat16, K % 8 == 0 and
// N % 8 == 0: every row of x, w and out is whole 16-byte chunks), 0 = the
// basic path.
extern "C" int dot_blocked_route(int dtype, int K, int N) {
  return dtype == 1 && K % 8 == 0 && N % 8 == 0 ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); a shape the grid cannot hold returns
// cudaErrorInvalidValue, and on the ring path x, w or y not 16-byte aligned
// cudaErrorMisalignedAddress, without launching.
extern "C" int dot_blocked(int dtype, const void* x, const void* w, void* y, long long M,
                           int K, int N, void* stream) {
  if (M <= 0 || K < 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dot_blocked_route(dtype, K, N) == 1) {
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
         reinterpret_cast<uintptr_t>(y)) & 15) {
      return (int)cudaErrorMisalignedAddress;
    }
    ring::RingArgs r;
    r.y = static_cast<__nv_bfloat16*>(y);
    r.M = M;
    r.K = K;
    r.N = N;
    return (int)ring::dispatch(x, w, r, s);
  }
  DotArgs a;
  a.x = x;
  a.w = w;
  a.y = y;
  a.M = M;
  a.K = K;
  a.N = N;
  if ((M + BM - 1) / BM > 0x7fffffffLL || (N + 15) / 16 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = dtype == 1 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
  return (int)err;
}

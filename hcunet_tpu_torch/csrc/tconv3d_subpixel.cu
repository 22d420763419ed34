// Transposed 3D convolution of stride (2, 2, 1) with an even x/y kernel, in
// its subpixel form, float32, channels-last, into a caller's buffer.
//
//   P[b,m,n,z,(2rx+ry)Cout+c] = bias[c] + sum_{ux,uy,uz,ci}
//       xpad[b, m+ux, n+uy, z+uz, ci] * W[ux,uy,uz,ci,(2rx+ry)Cout+c]
//   out[b, 2m+rx, 2n+ry, z, c] = P[b,m,n,z,(2rx+ry)Cout+c]
//
// x [B, X, Y, Z, Cin]; W [hx, hy, kz, Cin, 4 Cout], the four parity kernels
// of the transposed conv stacked along Cout (ops/tconv.py's
// subpixel_tconv_weights); bias [4 Cout], the transposed conv's repeated
// per parity; xpad is x zero-padded by (px, py, pz) on both sides
// (subpixel_pads).  out [B, CX, CY, CZ, CS] takes the top-left CX x CY x CZ
// of the transposed conv in channels 0 .. Cout - 1 and nothing else: the
// serving forward passes the input of the up level's first conv, whose
// channels Cout .. 2 Cout - 1 it fills with the skip, so no padded input,
// no parity tensor and no interleaved copy is ever made.
//
// Replaces no TPU kernel: the JAX package leaves its tconv_packed_subpixel
// to XLA.  Added because cuDNN's float32 transposed conv (its dgrad engine)
// ran the serving U-Net's three up levels at ~17 % of the card's float32
// peak, 69 % of a float32 tile batch's device time.
//
// Bound: at the production up levels (Cin 128 / 64 / 32, 4 Cout 256 / 128
// / 64, 32 taps) a stacked output does 2 x 32 x Cin x 4 Cout flops for 4 x
// (Cin + 4 Cout) bytes of input and output: thousands of flops a byte, far
// above the ridge, so the FMA units (67 TFLOP/s; float32 exact, no TF32,
// no tensor cores) bound it.  The design is that of a compute-bound FMA
// GEMM, M = output positions, N = 4 Cout, K = taps x Cin:
//
// * A block owns a 2 x 4 x 20 box of parity positions (20: the z extent
//   of every up level of the production tile) and 64 stacked channels.
//   Its 160 threads hold 8 positions x 8 channels of float32 sums each:
//   positions 4 y by 2 z of one x, channels 4 tn .. 4 tn + 3 and 32 + 4 tn
//   .. 32 + 4 tn + 3, so the 8 tn threads of a quarter warp read 128
//   contiguous bytes of weights and the 4 quarters 4 neighbouring boxes of
//   input.  Three blocks an SM (at most 128 registers a thread): 15 warps.
// * K runs over stages of 4 input channels x one ux (hy x kz taps).  A
//   stage holds the input slab those taps read, 2 x (4 + hy - 1) x (20 + kz
//   - 1) positions of 4 channels (16 bytes each), and the weights of the
//   stage's taps [hy][kz][4][64]: two TMA boxes, whose parts outside x or
//   W the copy fills with zeros (so the padding is never materialised).
//   The input is copied 2 x 7 x 21 / (2 x 4 x 20) = 1.8 times per ux, not
//   hy x kz = 8 times.  Thread 0 keeps the next stages of a ring of 4 in
//   flight; full and empty mbarriers, not block barriers, order the ring,
//   so no warp waits for another before its sums and only thread 0 issues
//   copies.  (Timed on an H100 at the production levels: copying the
//   stages with cp.async from every thread and a __syncthreads a stage
//   cost ~12 of ~72 ms.)
// * A tap's A fragment is 8 float4 loads (4 channels of each position);
//   its taps are walked by adding to one address, in one loop over the
//   stage's taps.  Per tap and thread: 16 shared loads of 16 bytes for 256
//   FMAs.  The loop stays rolled: unrolled, it spilled or outgrew the
//   instruction cache and ran slower; so did reading fewer A fragments
//   (both z taps from 12 loads), prefetching the next tap's, and 8 x 16
//   sums a thread.
// * The epilogue adds the bias and stores 16 bytes (4 channels of one
//   parity) at a time, straight to the interleaved position in out; a
//   position outside CX x CY x CZ is not stored (nor computed, where a
//   whole block lies outside).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is found at run time
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "hopper_tma.cuh"

namespace {

constexpr int NT = 160;                 // threads per block
constexpr int NW = NT / 32;             // warps per block
constexpr int TX = 2, TY = 4, TZ = 20;  // a block's box of parity positions
constexpr int BN = 64;                  // stacked channels per block
constexpr int NTN = 8;                  // threads along N, 8 channels each
constexpr int NTM = NT / NTN;           // threads along M, 8 positions each
constexpr int CC = 4;                   // input channels per stage
constexpr int STAGES = 4;
static_assert(NTM == TX * (TZ / 2) && TY == 4, "a thread's 8 positions: 4 y x 2 z");

struct Args {
  const float* bias;
  float* y;
  int Cin;
  int hx, kz;      // the parity kernel's x and z taps
  int px, py, pz;  // the parity conv's zero padding, each side
  int cout, n;     // Cout and the stacked N = 4 Cout
  int cx, cy, cz, cs;  // out's extent and channels
  int tiles_x, tiles_y, tiles_z, n_tiles;
  int sy, sz;        // the slab's extent: TY + hy - 1, TZ + kz - 1
  int slab_bytes;    // 16 TX sy sz, rounded up to 128 (a TMA box starts aligned)
  int taps;          // hy kz taps a stage
  int stage_bytes;   // slab_bytes + 16 BN taps
  int tx_bytes;      // the bytes the two boxes of a stage bring: 16 TX sy sz + 16 BN taps
};

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(NT, 3)
    tconv3d_subpixel_kernel(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_w,
                            const __grid_constant__ Args a) {
  // the ring on a 128-byte boundary, where TMA boxes land
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring0 = (raw + 127) & ~127u;
  const unsigned char* smem = smem_raw + (ring0 - raw);
  const uint32_t bar0 = ring0 + STAGES * a.stage_bytes;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };
  const int tid = threadIdx.x;

  // the block's N tile is the fastest index: the N tiles of one box run
  // together and read its input from L2
  int t = blockIdx.x;
  const int nt = t % a.n_tiles;
  t /= a.n_tiles;
  const int tz = t % a.tiles_z;
  t /= a.tiles_z;
  const int ty = t % a.tiles_y;
  t /= a.tiles_y;
  const int tx = t % a.tiles_x;
  const int b = t / a.tiles_x;
  const int m0 = tx * TX, q0 = ty * TY, z0 = tz * TZ;  // the box's corner
  const int n0 = nt * BN;
  const int KT = a.Cin / CC * a.hx;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);    // the producer's expect_tx
      hopper::mbar_init(empty(s), NW);  // one arrival per warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // stage j = (c, ux): channels 4c .. 4c + 3, taps (ux, uy, uz) for every
  // uy, uz; the slab's corner is (m0 - px + ux, q0 - py, z0 - pz)
  auto load_stage = [&](int j) {
    const int s = j % STAGES;
    const int c = j / a.hx, ux = j - c * a.hx;
    const uint32_t s0 = ring0 + s * a.stage_bytes;
    hopper::mbar_arrive_expect_tx(full(s), a.tx_bytes);
    hopper::tma_load_5d(s0, &map_x, full(s), CC * c, z0 - a.pz, q0 - a.py, m0 - a.px + ux, b);
    hopper::tma_load_5d(s0 + a.slab_bytes, &map_w, full(s), n0, CC * c, 0, 0, ux);
  };
  if (tid == 0) {
    for (int j = 0; j < STAGES - 1 && j < KT; ++j) load_stage(j);
  }

  // thread (tm, tn): x bx, z 2 zp + dz, y 0 .. 3 of the box; channels
  // 4 tn .. 4 tn + 3 and 32 + 4 tn .. 32 + 4 tn + 3 of the N tile
  const int tn = tid % NTN, tm = tid / NTN;
  const int bx = tm / (TZ / 2), zp = tm - bx * (TZ / 2);
  const int sz4 = 4 * a.sz;  // floats from one y of the slab to the next
  const int a_off = 4 * (bx * a.sy * a.sz + 2 * zp);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    // thread 0 refills the slot of stage kt - 1 with stage kt + STAGES - 1
    // once every warp is done with it
    const int j = kt + STAGES - 1;
    if (tid == 0 && j < KT) {
      if (j >= STAGES) hopper::mbar_wait(empty(j % STAGES), (j / STAGES - 1) & 1);
      load_stage(j);
    }
    const int slot = kt % STAGES;
    hopper::mbar_wait(full(slot), (kt / STAGES) & 1);

    const float* S = reinterpret_cast<const float*>(smem + slot * a.stage_bytes);
    const float* Ws = reinterpret_cast<const float*>(smem + slot * a.stage_bytes + a.slab_bytes) +
                      4 * tn;
    const float* A0 = S + a_off;
    // tap (uy, uz): rows (y, dz) = 2 y + dz read slab (bx, y + uy, 2 zp +
    // dz + uz) from ap, the tap's weights lie at bp
    const float* ap = A0;
    const float* bp = Ws;
    int uz = 0;
#pragma unroll 1
    for (int tap = 0; tap < a.taps; ++tap) {
      float4 av[8];
#pragma unroll
      for (int yy = 0; yy < 4; ++yy) {
        av[2 * yy] = *reinterpret_cast<const float4*>(ap + yy * sz4);
        av[2 * yy + 1] = *reinterpret_cast<const float4*>(ap + yy * sz4 + 4);
      }
#pragma unroll
      for (int kk = 0; kk < CC; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bp + kk * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(bp + kk * BN + 32);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ak = lane(av[i], kk);
          acc[i][0] = fmaf(ak, b0.x, acc[i][0]);
          acc[i][1] = fmaf(ak, b0.y, acc[i][1]);
          acc[i][2] = fmaf(ak, b0.z, acc[i][2]);
          acc[i][3] = fmaf(ak, b0.w, acc[i][3]);
          acc[i][4] = fmaf(ak, b1.x, acc[i][4]);
          acc[i][5] = fmaf(ak, b1.y, acc[i][5]);
          acc[i][6] = fmaf(ak, b1.z, acc[i][6]);
          acc[i][7] = fmaf(ak, b1.w, acc[i][7]);
        }
      }
      bp += CC * BN;
      ap += 4;
      if (++uz == a.kz) {
        uz = 0;
        ap += sz4 - 4 * a.kz;
      }
    }
    // this warp is done with the slot
    __syncwarp();
    if ((tid & 31) == 0) hopper::mbar_arrive(empty(slot));
  }

  // epilogue: channel group g holds stacked channels nc .. nc + 3 of one
  // parity p = (rx, ry); row (y, dz) is parity position (m0 + bx, q0 + y,
  // z0 + 2 zp + dz), stored at out (2 m + rx, 2 n + ry, z)
  const int pm = m0 + bx;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int nc = n0 + 4 * tn + 32 * g;
    if (nc >= a.n) continue;
    const int p = nc / a.cout;
    const int c = nc - p * a.cout;
    const int ox = 2 * pm + (p >> 1);
    if (ox >= a.cx) continue;
    const float4 bv = *reinterpret_cast<const float4*>(a.bias + nc);
#pragma unroll
    for (int yy = 0; yy < 4; ++yy) {
      const int oy = 2 * (q0 + yy) + (p & 1);
      if (oy >= a.cy) continue;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int oz = z0 + 2 * zp + dz;
        if (oz >= a.cz) continue;
        const float* v = acc[2 * yy + dz] + 4 * g;
        float* dst = a.y + ((((long long)b * a.cx + ox) * a.cy + oy) * a.cz + oz) * a.cs + c;
        *reinterpret_cast<float4*>(dst) =
            make_float4(v[0] + bv.x, v[1] + bv.y, v[2] + bv.z, v[3] + bv.w);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time (the library
// links only the CUDA runtime)
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

// A 5D float32 tensor map: extents `dims` innermost first, the innermost
// contiguous, boxes of `box`, no swizzle, zeros outside.
cudaError_t tensor_map_5d(CUtensorMap* map, const void* base, const long long (&dims)[5],
                          const int (&box)[5]) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], strides[4];
  cuuint32_t bx[5], elem_strides[5];
  cuuint64_t stride = 4;
  for (int i = 0; i < 5; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    elem_strides[i] = 1;
    if (i > 0) strides[i - 1] = stride;
    stride *= d[i];
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(base), d,
                            strides, bx, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// The parity conv of x (zero-padded by px, py, pz) with the stacked kernels
// w [hx, hy, kz, Cin, 4 Cout] plus bias, interleaved into channels 0 ..
// Cout - 1 of out [B, cx, cy, cz, cs].  Returns cudaGetLastError() after
// the launch (0 on success); without launching, cudaErrorInvalidValue for
// Cin, Cout or cs not a multiple of 4, cs < Cout, an out larger than the
// transposed conv, a grid too large for one launch, a stage beyond a
// block's shared memory or a tensor map cuTensorMapEncodeTiled refuses, and
// cudaErrorMisalignedAddress for a pointer not 16-byte aligned.
extern "C" int tconv3d_subpixel(const float* x, const float* w, const float* bias, float* y,
                                int B, int X, int Y, int Z, int Cin, int hx, int hy, int kz,
                                int px, int py, int pz, int Cout, int cx, int cy, int cz,
                                int cs, void* stream) {
  Args a;
  a.bias = bias;
  a.y = y;
  a.Cin = Cin;
  a.hx = hx;
  a.kz = kz;
  a.px = px;
  a.py = py;
  a.pz = pz;
  a.cout = Cout;
  a.n = 4 * Cout;
  a.cx = cx;
  a.cy = cy;
  a.cz = cz;
  a.cs = cs;
  // the parity grid and the part of it that out keeps
  const int xo = X + 2 * px - hx + 1, yo = Y + 2 * py - hy + 1, zo = Z + 2 * pz - kz + 1;
  if (B <= 0 || Cin <= 0 || Cin % 4 || Cout <= 0 || Cout % 4 || cs % 4 || cs < Cout ||
      hx <= 0 || hy <= 0 || kz <= 0 || px < 0 || py < 0 || pz < 0 || cx <= 0 || cy <= 0 ||
      cz <= 0 || cx > 2 * xo || cy > 2 * yo || cz > zo) {
    return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(y)) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  a.tiles_x = ((cx + 1) / 2 + TX - 1) / TX;
  a.tiles_y = ((cy + 1) / 2 + TY - 1) / TY;
  a.tiles_z = (cz + TZ - 1) / TZ;
  a.n_tiles = (a.n + BN - 1) / BN;
  a.sy = TY + hy - 1;
  a.sz = TZ + kz - 1;
  a.slab_bytes = (16 * TX * a.sy * a.sz + 127) / 128 * 128;
  a.taps = hy * kz;
  a.stage_bytes = a.slab_bytes + 4 * CC * BN * a.taps;
  a.tx_bytes = 16 * TX * a.sy * a.sz + 4 * CC * BN * a.taps;
  // the ring, its barriers, and room to align the ring
  const long long smem = (long long)STAGES * a.stage_bytes + 2 * STAGES * 8 + 128;
  const long long blocks = (long long)B * a.tiles_x * a.tiles_y * a.tiles_z * a.n_tiles;
  // a TMA box holds at most 256 elements an axis
  if (smem > 232448 || blocks > 0x7fffffffLL || a.sy > 256 || a.sz > 256) {
    return (int)cudaErrorInvalidValue;
  }

  // x as [B][X][Y][Z][Cin] in boxes of (4 channels, sz, sy, TX, 1); W as
  // [hx][hy][kz][Cin][N] in boxes of (BN, 4 channels, kz, hy, 1)
  CUtensorMap map_x, map_w;
  cudaError_t err = tensor_map_5d(&map_x, x, {Cin, Z, Y, X, B}, {CC, a.sz, a.sy, TX, 1});
  if (err == cudaSuccess) {
    err = tensor_map_5d(&map_w, w, {a.n, Cin, kz, hy, hx}, {BN, CC, kz, hy, 1});
  }
  if (err != cudaSuccess) return (int)err;

  auto* kernel = tconv3d_subpixel_kernel;
  // above 48 KB of dynamic shared memory a kernel must opt in, per device;
  // the size follows the taps, so set and launch under one lock (data
  // replicas launch from threads of their own)
  static std::mutex attribute_lock;
  std::lock_guard<std::mutex> hold(attribute_lock);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, NT, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(map_x, map_w,
                                                                                     a);
  return (int)cudaGetLastError();
}

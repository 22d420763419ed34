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
// The basic path, float32, and bfloat16 with any other Cin, is described
// where it is defined, below.  It alone takes zero padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

#include "hopper_mma.cuh"

namespace {

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
  int pad_x, pad_y, pad_z;  // low zero padding (the high one only sets Xo, Yo, Zo)
  int K;  // kx * ky * kz * Cin
  int relu;
};

// Offset of input voxel (b, xo, yo, zo), channel 0, of output row m < M
// (no padding).
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

// ---------------------------------------------------------------------------
// Shared by both paths.

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

// ---------------------------------------------------------------------------
// The basic path, float32, and bfloat16 with any other Cin (the U-Net's
// 4-channel first layer, the recurrent family's Cin 9, 10, 20 and 50, the
// input gradients whose Cin' = Cout is not a multiple of 8).  It also takes
// per-axis zero padding, low and high, so that a same-padding conv and the
// input gradient of one read the unpadded tensor: output extent X + lo +
// hi - d (k - 1), and a tap outside the input reads zeros.
//
// What held the first version back was latency, not work: it gathered each
// 32-deep K step element by element into registers and then shared memory,
// two barriers apart from the math, dividing four times per element to find
// its tap.  At RDCNet's shapes (K = 125 x 10, Cout 10) a block walked ~40
// such steps in series: ~110 us a conv on an H100 against a bound of ~1.4
// us.  Here:
//
// * A ring of 3 (float32) or 4 (bf16) stages in dynamic shared memory,
//   filled by cp.async while the block works on an earlier stage; one
//   __syncthreads per stage.  A copy is as wide as alignment allows: 16
//   bytes (through L2 only) where Cin * sizeof(T) and x allow it, else 8
//   or 4 (bf16 Cin 4 and 20: 8, Cin 10 and 50: 4; float32 16 or 4), and
//   for bf16 with an odd Cin (or an input at an odd element) 2 bytes by
//   plain loads.  The
//   weights follow Cout's alignment the same way.  A copy past M, past K
//   or of a tap outside the input is zero-filled (src-size 0), never read.
// * Skipped taps.  Each row keeps one bit per in-range tap index on each
//   axis (10 bits an axis); the block ORs them, and a tap whose three bits
//   are not all set somewhere in the block is left out of the K walk: no
//   copy and no multiply (at dilation 5 on a 5-deep z, 4 of the 5 z taps).
//   A tap in range for some rows only is zero-filled for the others.  The
//   sum runs over the kept taps in K order, so a float32 output voxel sums
//   the same terms in the same order in any block: zero terms add nothing.
// * No division in the mainloop.  The kept taps form a list in shared
//   memory; per stage one lane per K column of the stage advances its
//   (tap, channel) by adds (the host splits the stage depth as q Cin + r)
//   and writes the column's input offset, tap bits and weight row into a
//   small table that the copies of that stage read.  Rows are decomposed
//   once, with the ring path's FastDiv.
// * bfloat16: 256 threads, 128 rows, each warp 16 rows and the whole N tile
//   (8, 16, 32 or 64 following Cout), mma.sync m16n8k16 fed by ldmatrix
//   (.trans for the [K, N] weights), float32 accumulators, and the bias,
//   ReLU and bf16 store straight from them.
// * float32 on the FMA units, float32 to the last bit (no TF32): each
//   thread holds 8 rows x 4 columns (4 x 4 for Cout <= 16), reading 4 K
//   columns of a row at once (the A tile keeps K contiguous, as the copies
//   land it) and 4 weights at once; 256 rows a block for Cout <= 32, 128
//   for more.  At Cout <= 16 the gather, one copy of every input element
//   per tap, is what bounds it; staging a block's input box once per
//   channel slice is not done yet.
//
// Bound: RDCNet's convs and the padded input gradients move a few MB and
// do a few GFLOP, microseconds of the card, so their launches and the
// block's set-up set their time; the float32 U-Net layers are bound by the
// FMA units (67 TFLOP/s), and run at about half of that where Cout >= 32.

namespace basic {

constexpr int NT = 256;             // threads per block
constexpr int ROW_REGS = 8;         // a thread keeps up to this many rows' state in registers
constexpr int AXIS_BITS = 10;       // tap bits per axis in a row's mask
constexpr uint32_t NO_TAP = 1u << 31;  // bits no row holds: a K column past the kept taps

// One kept tap, or one K column of a stage: the input offset from a row's
// base, the tap's axis bits, and the weight row (-1: past the kept taps).
struct TapEntry {
  long long xoff;
  uint32_t bits;
  int wrow;
};

// One output row: the input offset of its (possibly padded-away) corner
// voxel, channel 0, and its in-range tap bits (0 past M).
struct RowEntry {
  long long base;
  uint32_t mask;
  int pad_;
};

struct BasicArgs {
  ConvArgs a;
  FastDiv zo, yo, xo;  // row m -> (b, xo, yo, zo), used when M < 2^31
  int q, r;            // the stage depth as q Cin + r
  int vb;              // bytes per weight copy: 16, 8, 4 or 2
  int cpb_shift;       // log2 of the weight copies per stage row
};

// The tile of each type and N width.
template <typename T, int BN>
struct Cfg;

template <int BN_>
struct Cfg<__nv_bfloat16, BN_> {
  static constexpr int BN = BN_;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int BM = 128;  // 8 warps of 16 rows
  static constexpr int BK = 32;
  static constexpr int STAGES = 4;
  static constexpr int A_LD = BK + 8;                  // 80-byte rows: ldmatrix without conflicts
  static constexpr int B_LD = BN == 8 ? 24 : BN + 8;   // 48, 48, 80 or 144-byte rows
};

template <int BN_>
struct Cfg<float, BN_> {
  // 8 rows x 4 columns a thread, 4 x 4 for N = 16, whose blocks are held
  // to three an SM (at most 85 registers a thread): at N = 16 the time goes
  // into gathering each input element once per tap, and more blocks in
  // flight hide more of it.  Stages 16 deep, 32 for N = 64, where the
  // longer stage halves the barriers per FMA and two blocks still fit.
  // (Chosen among 8 x 8, 8 x 4 in 512-row blocks, 4- and 8-deep variants
  // by timing the U-Net's layers on an H100.)
  static constexpr int BN = BN_;
  static constexpr int MIN_BLOCKS = BN == 16 ? 3 : 2;
  static constexpr int TN = 4;              // columns per thread
  static constexpr int TM = BN == 16 ? 4 : 8;  // rows per thread
  static constexpr int NTN = BN / TN;       // threads along N
  static constexpr int NTM = NT / NTN;      // threads along M
  static constexpr int BM = NTM * TM;       // 256, 256, 128
  static constexpr int BK = BN == 64 ? 32 : 16;
  static constexpr int STAGES = 3;
  static constexpr int A_LD = BK + 4;
  static constexpr int B_LD = BN + 4;
};

template <typename T, int BN>
struct Layout {
  using C = Cfg<T, BN>;
  static constexpr int A_ELEMS = C::BM * C::A_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + C::BK * C::B_LD;
  static constexpr int RING_BYTES = C::STAGES * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int ROWS_BYTES = C::BM * (int)sizeof(RowEntry);
  static constexpr int TABLE_BYTES = C::STAGES * C::BK * (int)sizeof(TapEntry);
  // the kept-tap list (taps + 1 entries) comes last
  static int bytes(int taps) {
    return RING_BYTES + ROWS_BYTES + TABLE_BYTES + (taps + 1) * (int)sizeof(TapEntry);
  }
};

// dst (shared) <- src (global), N = 4, 8 or 16 bytes; ok = false writes
// zeros and reads nothing
template <int N>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(N),
               "r"(ok ? N : 0)
               : "memory");
}

// a copy of N bytes: 16 through L2 only (the gathered rows are re-read
// from L2 faster than L1 keeps them: measured on an H100), 8 and 4 through
// L1, 2 by a plain load and store (the slot it writes is one no thread
// reads until the next barrier)
template <int N, typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool ok) {
  if constexpr (N == 2) {
    const unsigned short v = ok ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
    *reinterpret_cast<unsigned short*>(dst) = v;
  } else if constexpr (N == 16) {
    hopper::cp_async16_cg(hopper::smem_addr(dst), src, ok ? 16 : 0);
  } else {
    cp_async_ca<N>(hopper::smem_addr(dst), src, ok);
  }
}

template <typename T>
__device__ __forceinline__ void copy_weights(T* dst, const T* src, bool ok, int vb) {
  switch (vb) {
    case 16: copy_chunk<16>(dst, src, ok); break;
    case 8: copy_chunk<8>(dst, src, ok); break;
    case 4: copy_chunk<4>(dst, src, ok); break;
    default:
      if constexpr (sizeof(T) == 2) copy_chunk<2>(dst, src, ok);
      break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bit t set where tap t of an axis (kernel k, dilation d) lands inside [0, n)
// for a row whose tap 0 sits at p
__device__ __forceinline__ uint32_t axis_bits(int p, int k, int d, int n) {
  uint32_t bits = 0;
  for (int t = 0; t < k; ++t, p += d) {
    if (p >= 0 && p < n) bits |= 1u << t;
  }
  return bits;
}

template <typename T, int BN, int VEC>
__global__ void __launch_bounds__(NT, Cfg<T, BN>::MIN_BLOCKS)
    conv3d_valid_kernel(const __grid_constant__ BasicArgs p) {
  using C = Cfg<T, BN>;
  using L = Layout<T, BN>;
  constexpr int BM = C::BM, BK = C::BK, STAGES = C::STAGES;
  constexpr int E = VEC / (int)sizeof(T);  // elements per input copy
  constexpr int CPR = BK / E;              // input copies per row and stage
  constexpr int RSTEP = NT / CPR;          // rows between a thread's copies
  constexpr int RPT = BM / RSTEP;          // rows per thread
  constexpr bool kRowRegs = RPT <= ROW_REGS;
  static_assert(E >= 1 && BK % E == 0 && NT % CPR == 0 && BM % RSTEP == 0, "tile");
  const ConvArgs& a = p.a;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_or;
  __shared__ int s_ntaps;
  T* ring = reinterpret_cast<T*>(smem);
  RowEntry* rows = reinterpret_cast<RowEntry*>(smem + L::RING_BYTES);
  TapEntry* table = reinterpret_cast<TapEntry*>(smem + L::RING_BYTES + L::ROWS_BYTES);
  TapEntry* list = table + STAGES * BK;

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.w);
  T* __restrict__ y = static_cast<T*>(a.y);
  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  if (tid == 0) s_or = 0;
  __syncthreads();

  // each row's corner offset and in-range tap bits, once per row
  uint32_t any = 0;
  for (int r = tid; r < BM; r += NT) {
    const long long m = m0 + r;
    RowEntry e{0, 0u, 0};
    if (m < a.M) {
      long long b;
      int xo, yo, zo;
      if (a.M < (1LL << 31)) {
        const uint32_t t0 = (uint32_t)m;
        const uint32_t t1 = p.zo.div(t0);
        const uint32_t t2 = p.yo.div(t1);
        const uint32_t bb = p.xo.div(t2);
        b = bb;
        zo = (int)(t0 - t1 * a.Zo);
        yo = (int)(t1 - t2 * a.Yo);
        xo = (int)(t2 - bb * a.Xo);
      } else {
        long long t = m;
        zo = (int)(t % a.Zo);
        t /= a.Zo;
        yo = (int)(t % a.Yo);
        t /= a.Yo;
        xo = (int)(t % a.Xo);
        b = t / a.Xo;
      }
      const int x0 = xo - a.pad_x, y0 = yo - a.pad_y, z0 = zo - a.pad_z;
      e.mask = axis_bits(x0, a.kx, a.dil_x, a.X) |
               axis_bits(y0, a.ky, a.dil_y, a.Y) << AXIS_BITS |
               axis_bits(z0, a.kz, a.dil_z, a.Z) << (2 * AXIS_BITS);
      e.base = (((b * a.X + x0) * a.Y + y0) * (long long)a.Z + z0) * a.Cin;
    }
    rows[r] = e;
    any |= e.mask;
  }
  any = __reduce_or_sync(0xffffffffu, any);
  if ((tid & 31) == 0 && any != 0) atomicOr(&s_or, any);
  __syncthreads();

  // the taps some row of the block reaches, in K order (warp 0), and the
  // sentinel after them
  const int taps = a.kx * a.ky * a.kz;
  if (tid < 32) {
    const uint32_t reach = s_or;
    int n = 0;
    for (int t0 = 0; t0 < taps; t0 += 32) {
      const int t = t0 + tid;
      TapEntry e{0, 0u, 0};
      bool on = false;
      if (t < taps) {
        const int dz = t % a.kz;
        const int dy = t / a.kz % a.ky;
        const int dx = t / a.kz / a.ky;
        e.bits = 1u << dx | 1u << (AXIS_BITS + dy) | 1u << (2 * AXIS_BITS + dz);
        e.xoff = (((long long)dx * a.dil_x * a.Y + (long long)dy * a.dil_y) * a.Z +
                  (long long)dz * a.dil_z) * a.Cin;
        e.wrow = t * a.Cin;
        on = (reach & e.bits) == e.bits;
      }
      const uint32_t ballot = __ballot_sync(0xffffffffu, on);
      if (on) list[n + __popc(ballot & ((1u << tid) - 1u))] = e;
      n += __popc(ballot);
    }
    if (tid == 0) {
      list[n] = TapEntry{0, NO_TAP, -1};
      s_ntaps = n;
    }
  }
  __syncthreads();
  const int ntaps = s_ntaps;
  const int KT = (int)(((long long)ntaps * a.Cin + BK - 1) / BK);

  // The table walk: lane kk < BK of warp 0 follows K column kk of every
  // stage through the kept taps, by adds, and writes the stage's table slot.
  int wj = 0, wci = 0;
  if (tid < BK) {
    wj = tid / a.Cin;
    wci = tid - wj * a.Cin;
  }
  auto write_table = [&](int slot) {
    if (tid < BK) {
      TapEntry e{0, NO_TAP, -1};
      if (wj < ntaps) {
        const TapEntry t = list[wj];
        e.xoff = t.xoff + wci;
        e.bits = t.bits;
        e.wrow = t.wrow + wci;
      }
      table[slot * BK + tid] = e;
      wci += p.r;
      wj += p.q;
      if (wci >= a.Cin) {
        wci -= a.Cin;
        ++wj;
      }
    }
  };

  // A thread copies K columns E c .. E c + E - 1 of rows rrow + RSTEP i.
  const int c = tid % CPR;
  const int rrow = tid / CPR;
  RowEntry rreg[kRowRegs ? RPT : 1];
  if constexpr (kRowRegs) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) rreg[i] = rows[rrow + RSTEP * i];
  }
  const int cpb = 1 << p.cpb_shift;
  const int eb = p.vb / (int)sizeof(T);
  const int btot = BK << p.cpb_shift;

  auto load_stage = [&](int slot) {
    T* As = ring + slot * L::STAGE_ELEMS;
    T* Bs = As + L::A_ELEMS;
    const TapEntry te = table[slot * BK + c * E];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rrow + RSTEP * i;
      RowEntry re;
      if constexpr (kRowRegs) {
        re = rreg[i];
      } else {
        re = rows[r];
      }
      const bool ok = (re.mask & te.bits) == te.bits;
      copy_chunk<VEC>(As + r * C::A_LD + c * E, ok ? x + (re.base + te.xoff) : x, ok);
    }
    for (int q = tid; q < btot; q += NT) {
      const int kb = q >> p.cpb_shift;
      const int cc = q & (cpb - 1);
      const int wrow = table[slot * BK + kb].wrow;
      const int n = n0 + cc * eb;
      const bool ok = wrow >= 0 && n < a.Cout;
      copy_weights(Bs + kb * C::B_LD + cc * eb, ok ? w + ((long long)wrow * a.Cout + n) : w, ok,
                   p.vb);
    }
  };

  // prologue: the tables of stages 0 .. STAGES - 1, the copies of 0 .. STAGES - 2
#pragma unroll
  for (int s = 0; s < STAGES; ++s) write_table(s);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s);
    hopper::cp_async_commit();
  }

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int NJ = BN / 8;  // n8 tiles
    const int warp = tid >> 5, lane = tid & 31;
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    int slot = 0;
    for (int kt = 0; kt < KT; ++kt) {
      // stage kt has landed for every thread, and every thread is done with
      // stage kt - 1, whose ring slot the next copies refill; table slot
      // `slot` held stage kt's columns, copied long ago
      hopper::cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int prev = slot == 0 ? STAGES - 1 : slot - 1;
      write_table(slot);
      if (kt + STAGES - 1 < KT) load_stage(prev);
      hopper::cp_async_commit();

      const __nv_bfloat16* As = ring + slot * L::STAGE_ELEMS;
      const __nv_bfloat16* Bs = As + L::A_ELEMS;
      const uint32_t a_addr =
          hopper::smem_addr(As + (warp * 16 + (lane & 15)) * C::A_LD + (lane >> 4) * 8);
      const uint32_t b_addr = hopper::smem_addr(Bs + (lane & 15) * C::B_LD + (lane >> 4) * 8);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, a_addr + ks * 16 * 2);
        if constexpr (NJ == 1) {
          uint32_t bf[2];
          ldmatrix_x2_trans(bf, b_addr + ks * 16 * C::B_LD * 2);
          mma_16816(acc[0], af, bf[0], bf[1]);
        } else {
#pragma unroll
          for (int j = 0; j < NJ; j += 2) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, b_addr + (ks * 16 * C::B_LD + j * 8) * 2);
            mma_16816(acc[j], af, bf[0], bf[1]);
            mma_16816(acc[j + 1], af, bf[2], bf[3]);
          }
        }
      }
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }
    hopper::cp_async_wait<0>();

    // epilogue from the accumulators: acc[j][2h + e] is row 8h + lane / 4
    // of the warp's 16, column 8j + 2 (lane % 4) + e
    const long long row = m0 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + 8 * j + 2 * (lane & 3);
      if (n >= a.Cout) continue;
      const bool pair = n + 1 < a.Cout;
      const float b0 = a.bias[n];
      const float b1 = pair ? a.bias[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = row + 8 * h;
        if (m >= a.M) continue;
        float v0 = acc[j][2 * h] + b0;
        float v1 = acc[j][2 * h + 1] + b1;
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
  } else {
    // thread (tm, tn): rows tm + NTM i, columns 4 tn .. 4 tn + 3
    constexpr int TM = C::TM, NTM = C::NTM, NTN = C::NTN;
    const int tn = tid % NTN, tm = tid / NTN;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

    int slot = 0;
    for (int kt = 0; kt < KT; ++kt) {
      hopper::cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int prev = slot == 0 ? STAGES - 1 : slot - 1;
      write_table(slot);
      if (kt + STAGES - 1 < KT) load_stage(prev);
      hopper::cp_async_commit();

      const float* As = ring + slot * L::STAGE_ELEMS;
      const float* Bs = As + L::A_ELEMS;
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 av[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          av[i] = *reinterpret_cast<const float4*>(As + (tm + NTM * i) * C::A_LD + k4);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 bv = *reinterpret_cast<const float4*>(Bs + (k4 + kk) * C::B_LD + 4 * tn);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float ak = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
            acc[i][0] = fmaf(ak, bv.x, acc[i][0]);
            acc[i][1] = fmaf(ak, bv.y, acc[i][1]);
            acc[i][2] = fmaf(ak, bv.z, acc[i][2]);
            acc[i][3] = fmaf(ak, bv.w, acc[i][3]);
          }
        }
      }
      slot = slot + 1 == STAGES ? 0 : slot + 1;
    }
    hopper::cp_async_wait<0>();

    // epilogue: rows tm + NTM i, columns 4 tn .. 4 tn + 3
    const int n = n0 + 4 * tn;
    if (n >= a.Cout) return;
    float bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = n + e < a.Cout ? a.bias[n + e] : 0.f;
    const bool vec = (a.Cout & 3) == 0 && n + 3 < a.Cout;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + tm + NTM * i;
      if (m >= a.M) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[i][e] + bv[e];
        if (a.relu) v[e] = fmaxf(v[e], 0.f);
      }
      float* dst = y + m * a.Cout + n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n + e < a.Cout) dst[e] = v[e];
        }
      }
    }
  }
}

template <typename T, int BN, int VEC>
cudaError_t launch(const BasicArgs& p, cudaStream_t stream) {
  using C = Cfg<T, BN>;
  auto* kernel = conv3d_valid_kernel<T, BN, VEC>;
  const int smem = Layout<T, BN>::bytes(p.a.kx * p.a.ky * p.a.kz);
  const long long m_tiles = (p.a.M + C::BM - 1) / C::BM;
  if (m_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)m_tiles, (unsigned)((p.a.Cout + BN - 1) / BN));
  // above 48 KB of dynamic shared memory a kernel must opt in, per device.
  // The attribute belongs to the kernel, which every host thread shares,
  // and smem follows the taps: set and launch under one lock, or a thread
  // that sets a smaller size in between (data-parallel replicas launch from
  // threads of their own) gets this launch refused
  static std::mutex attribute_lock;
  std::lock_guard<std::mutex> hold(attribute_lock);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// the widest copy, of 16, 8, 4 (and for bf16 2) bytes, that divides both
// the row of `elems` elements and the base address
template <typename T>
int copy_bytes(int elems, const void* ptr) {
  const uintptr_t row = (uintptr_t)elems * sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(ptr);
  for (int v : {16, 8, 4}) {
    if (row % v == 0 && addr % v == 0) return v;
  }
  return 2;
}

template <typename T, int BN>
cudaError_t launch_bn(BasicArgs& p, cudaStream_t stream) {
  constexpr int BK = Cfg<T, BN>::BK;
  p.q = BK / p.a.Cin;
  p.r = BK - p.q * p.a.Cin;
  p.vb = copy_bytes<T>(p.a.Cout, p.a.w);
  int shift = 0;
  while ((1 << shift) * p.vb < BN * (int)sizeof(T)) ++shift;
  p.cpb_shift = shift;
  const int vec = copy_bytes<T>(p.a.Cin, p.a.x);
  if constexpr (std::is_same<T, float>::value) {
    return vec == 16 ? launch<T, BN, 16>(p, stream) : launch<T, BN, 4>(p, stream);
  } else {
    // bf16 on this path has Cin % 8 != 0: 8, 4 or 2 bytes
    if (vec >= 8) return launch<T, BN, 8>(p, stream);
    if (vec == 4) return launch<T, BN, 4>(p, stream);
    return launch<T, BN, 2>(p, stream);
  }
}

template <typename T>
cudaError_t dispatch(const ConvArgs& a, cudaStream_t stream) {
  if (a.kx > AXIS_BITS || a.ky > AXIS_BITS || a.kz > AXIS_BITS) return cudaErrorInvalidValue;
  BasicArgs p;
  p.a = a;
  p.zo.init(a.Zo);
  p.yo.init(a.Yo);
  p.xo.init(a.Xo);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.Cout <= 8) return launch_bn<T, 8>(p, stream);
    if (a.Cout <= 16) return launch_bn<T, 16>(p, stream);
    if (a.Cout <= 32) return launch_bn<T, 32>(p, stream);
    return launch_bn<T, 64>(p, stream);
  } else {
    if (a.Cout <= 16) return launch_bn<T, 16>(p, stream);
    if (a.Cout <= 32) return launch_bn<T, 32>(p, stream);
    return launch_bn<T, 64>(p, stream);
  }
}

}  // namespace basic

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

// dtype: 0 = float32, 1 = bfloat16.  pad_lo/pad_hi: zero padding before and
// after each spatial axis (x, y, z), taken by the basic path alone: the
// output extent is X + lo + hi - dil (k - 1).  Returns cudaGetLastError()
// after the launch (0 on success); a grid too large for one launch, padding
// on the ring path, a negative padding or (basic path) a kernel wider than
// 10 on an axis returns cudaErrorInvalidValue, and x or w not 16-byte
// aligned on the ring path cudaErrorMisalignedAddress, without launching.
extern "C" int conv3d_valid(int dtype, const void* x, const void* w, const float* bias,
                            void* y, int B, int X, int Y, int Z, int Cin, int kx, int ky,
                            int kz, int dil_x, int dil_y, int dil_z, int pad_lo_x,
                            int pad_hi_x, int pad_lo_y, int pad_hi_y, int pad_lo_z,
                            int pad_hi_z, int Cout, int relu, void* stream) {
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
  a.pad_x = pad_lo_x;
  a.pad_y = pad_lo_y;
  a.pad_z = pad_lo_z;
  a.Xo = X + pad_lo_x + pad_hi_x - dil_x * (kx - 1);
  a.Yo = Y + pad_lo_y + pad_hi_y - dil_y * (ky - 1);
  a.Zo = Z + pad_lo_z + pad_hi_z - dil_z * (kz - 1);
  a.Cout = Cout;
  a.K = kx * ky * kz * Cin;
  a.relu = relu;
  a.M = (long long)B * a.Xo * a.Yo * a.Zo;
  const bool padded = (pad_lo_x | pad_hi_x | pad_lo_y | pad_hi_y | pad_lo_z | pad_hi_z) != 0;
  if (a.Xo <= 0 || a.Yo <= 0 || a.Zo <= 0 || a.M <= 0 || Cout <= 0 ||
      (a.M + 127) / 128 > 0x7fffffffLL ||
      (pad_lo_x | pad_hi_x | pad_lo_y | pad_hi_y | pad_lo_z | pad_hi_z) < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (conv3d_valid_route(dtype, Cin, Cout) == 1) {
    if (padded) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) {
      return (int)cudaErrorMisalignedAddress;
    }
    return (int)ring::dispatch(a, s);
  }
  cudaError_t err =
      dtype == 1 ? basic::dispatch<__nv_bfloat16>(a, s) : basic::dispatch<float>(a, s);
  return (int)err;
}

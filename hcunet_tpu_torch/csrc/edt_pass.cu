// Kernel K2: one separable exact-EDT pass over one axis of a float32 volume.
//
//     out[r, j] = min_k  d[r, k] + (j - k)^2        for every row r, j < n
//
// A "row" is the line of n elements along the pass axis.  The volume is
// contiguous and seen as [outer, n, inner]: row r = (o, i) with
// o = r / inner, i = r % inner, and its element k sits at
// o * n * inner + k * inner + i.  The kernel walks the axis in place, with
// the stride (inner) passed in, so no transposed copy is made.  Passes over
// axes 0 and 1 of an [X, Y, Z] volume, then a square root, give the exact
// per-z-slice EDT (scipy.ndimage.distance_transform_edt).
//
// Replaces the TPU Pallas kernel scripts/probe_edt_device.py::_edt_pass_kernel
// (edt_axis_pass_rows, driven by edt_pallas), which padded rows to 8 x 128
// blocks with 1e12.  Here every ragged edge (rows, j, k) is masked instead,
// and all offsets are 64-bit.
//
// Design: a block owns ROWS rows that are adjacent in row order (for
// inner > 1 they are adjacent in memory) and a chunk of JCHUNK outputs j.
// It stages the rows' values d[r, k] for a chunk of KCHUNK k's in shared
// memory (32 KB, so no opt-in above 48 KB is needed) and loops over the k
// chunks; each thread keeps the running minimum of JPER outputs of one row
// in registers.  Per (j, k) pair it squares j - k, adds d and takes the
// minimum, plus one FADD to step j - k.  The square and the sum are rounded
// separately (__fmul_rn, then an add that cannot fuse with it), as the plain
// version and the JAX package round them, so the results agree bit for bit
// at any n, not only where the square is exact (n <= 4096).
//
// What bounds it: this min-plus form does 2 * R * n^2 operations per pass
// (R = rows), which at the instance-tile shape [1323, 1323, 15] is
// 6.95e10 (j, k) pairs for the two passes, 2.07 ms at the 67 TFLOP/s
// float32 peak; the bytes (one read and one write of the volume per pass)
// take 0.125 ms at 3.35 TB/s.  So the kernel is bound by operations, and
// only a lower-envelope EDT (Felzenszwalb-Huttenlocher, O(n) per row) can
// approach the bytes bound.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;              // rows per block
constexpr int JLANES = 16;            // threads per row
constexpr int JPER = 8;               // outputs per thread
constexpr int JCHUNK = JLANES * JPER; // outputs per block
constexpr int KCHUNK = 512;           // staged k per round
constexpr int THREADS = ROWS * JLANES;

__global__ void __launch_bounds__(THREADS)
edt_pass_kernel(const float* __restrict__ d, float* __restrict__ out,
                int64_t rows, int64_t n, int64_t inner)
{
    // +1 pad: staging with k fastest (inner == 1) writes conflict-free
    __shared__ float seg[KCHUNK * (ROWS + 1)];

    const int tid = threadIdx.x;
    const int g = tid % ROWS;            // this thread's row in the block
    const int jl = tid / ROWS;           // this thread's j lane
    const int64_t r0 = (int64_t)blockIdx.x * ROWS;
    const int64_t j0 = (int64_t)blockIdx.y * JCHUNK;
    const int64_t row_stride = n * inner;

    float acc[JPER];
#pragma unroll
    for (int t = 0; t < JPER; ++t) acc[t] = CUDART_INF_F;

    for (int64_t k0 = 0; k0 < n; k0 += KCHUNK) {
        const int kc = (int)(n - k0 < KCHUNK ? n - k0 : KCHUNK);
        __syncthreads();  // the previous chunk is consumed
        for (int idx = tid; idx < kc * ROWS; idx += THREADS) {
            int k, gg;
            if (inner == 1) {  // a row is contiguous: k fastest coalesces
                k = idx % kc;
                gg = idx / kc;
            } else {           // adjacent rows are contiguous: row fastest
                gg = idx % ROWS;
                k = idx / ROWS;
            }
            const int64_t r = r0 + gg;
            float v = CUDART_INF_F;
            if (r < rows) {
                const int64_t base = (r / inner) * row_stride + (r % inner);
                v = d[base + (k0 + k) * inner];
            }
            seg[k * (ROWS + 1) + gg] = v;
        }
        __syncthreads();

        // dj[t] = j_t - k, stepped down by one per k (exact in float)
        float dj[JPER];
#pragma unroll
        for (int t = 0; t < JPER; ++t)
            dj[t] = (float)(j0 + jl + t * JLANES - k0);
        for (int k = 0; k < kc; ++k) {
            const float v = seg[k * (ROWS + 1) + g];
#pragma unroll
            for (int t = 0; t < JPER; ++t) {
                acc[t] = fminf(acc[t], v + __fmul_rn(dj[t], dj[t]));
                dj[t] -= 1.0f;
            }
        }
    }

    const int64_t r = r0 + g;
    if (r >= rows) return;
    const int64_t base = (r / inner) * row_stride + (r % inner);
#pragma unroll
    for (int t = 0; t < JPER; ++t) {
        const int64_t j = j0 + jl + t * JLANES;
        if (j < n) out[base + j * inner] = acc[t];
    }
}

}  // namespace

// d, out: contiguous float32 volumes of the same shape, seen as
// [outer, n, inner]; rows = outer * inner.  Returns cudaGetLastError().
extern "C" int edt_pass(const void* d, void* out, long long rows, long long n,
                        long long inner, void* stream)
{
    if (rows <= 0 || n <= 0) return 0;
    const long long row_blocks = (rows + ROWS - 1) / ROWS;
    const long long j_blocks = (n + JCHUNK - 1) / JCHUNK;
    if (row_blocks > 0x7fffffffLL || j_blocks > 65535LL) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)row_blocks, (unsigned)j_blocks);
    edt_pass_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)d, (float*)out, rows, n, inner);
    return (int)cudaGetLastError();
}

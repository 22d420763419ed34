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
// (edt_axis_pass_rows, driven by edt_pallas), which computed the min-plus
// form, every j against every k, on rows padded to 8 x 128 blocks.
//
// Design: the lower envelope of the parabolas k -> d[k] + (j - k)^2, in
// O(n) per row (Felzenszwalb and Huttenlocher, "Distance Transforms of
// Sampled Functions", Theory of Computing 8, 2012), in the integer form of
// Meijster et al. (2000): the stack keeps only the vertices that are the
// minimum at one integer j at least, each with t, the first j it owns.
// One thread walks one row; the lanes of a warp take consecutive rows, so
// for inner > 1 their reads of d[k] and writes of out[j] at one k or j are
// adjacent in memory (the axis-0 pass of an [X, Y, Z] tile: one run of 32;
// axis 1 with Z = 15: about three runs of 15).  A row with inner == 1 (a
// pass over the last axis, which no path of the port runs) is walked in
// place as well, each lane along its own contiguous row.
//   1. Build: for k = 0 .. n-1, pop the top while k owns all of the top's
//      j's, then push k if it owns a j < n.
//   2. Sweep j from n-1 down to 0, stepping down the stack where j falls
//      below the current vertex's t, and write
//      out[j] = d[v] + (j - v)^2, the square rounded first, then the sum,
//      as the plain version rounds them (__fmul_rn, __fadd_rn).
// The stack lives in the row's own output: vertex p is stored as an int at
// out[p].  This is safe because every kept vertex owns a j of its own, so
// t[p] >= p: while the sweep is at vertex p and some j >= t[p], the
// entries it reads lie below p (indices < p <= j), and only out[j + 1 ..]
// are written.  So the kernel needs no scratch and no shared memory, and
// n is bounded only by the exactness below.
//
// Exactness: the first j that b owns against a < b is floor(N / D) + 1,
// N = (d[b] + b^2) - (d[a] + a^2), D = 2 (b - a) (a keeps the ties), taken
// in double and corrected by the exact products q * D against N.  Where
// d is integer-valued with d + n^2 < 2^53 (edt() feeds 0, 1e12 and sums of
// squares) N and those products are exact, so the argmin is exact, and
// since rounding is monotone, min_k fl(x_k) = fl(min_k x_k): for n <= 4096,
// where every (j - k)^2 is exact in float32, the output equals the plain
// version's bits, ties included.  Where the squares round (n > 4096) the
// two may differ by 2 ulps for d >= 0 (the kernel's argmin of the exact
// sum against the plain version's min of the rounded one); for
// non-integer float32 d >= 0 at n <= 4096, by 1 ulp (N rounds in double
// only when d and k^2 lie more than 53 bits apart).  Measured on the
// card: 0 ulps in every case the
// tests hold it to (tests/test_torch_port_cuda.py, EDT_CASES and the two
// edt_axis_pass cases).  An infinite d never owns a j (inf - inf is
// treated as "not before n").
//
// What bounds it on this card: the bytes are one read and one write of the
// volume per pass, 0.125 ms for both passes of the instance tile
// [1323, 1323, 15] at 3.35 TB/s, and the operations a few per element.
// Neither binds.  Three things do (PERF.md, section 6, K2):
//   - few threads: a pass has only rows = 19845 chains of 2n dependent
//     steps, 620 warps, under five per SM, too few to hide latency;
//   - divergence: the lanes of a warp push, pop and step down at
//     different steps, so the warp pays for every lane's event, and a long
//     run of pops in one lane (a row that starts with foreground) holds
//     the other 31;
//   - scattered stack traffic: each lane's stack sits at its own depth,
//     so each 4-byte entry read or written moves a 32-byte sector.
// What the design does about it: the build loads d a chunk (CHUNK steps)
// ahead; the pop test is a multiply and a compare against the top's t (a
// division only when a vertex is pushed); the top and CACHE entries below
// it stay in registers with their d and t, topped up from memory once a
// chunk at a point the whole warp reaches together, so the warp waits for
// the stack once a chunk, not whenever one lane runs dry; row offsets are
// 32-bit where a row's extent allows.  Banding (several lanes per row,
// Cao et al., I3D 2010) would address the first two and needs memory
// beside the output for the band envelopes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;  // one warp per block: a pass has few rows
constexpr int CHUNK = 8;     // build and sweep steps between cache top-ups
constexpr int CACHE = CHUNK; // stack entries below the top held in registers
// n bound: q * D and j * D stay exact in double (< 2^53)
constexpr long long MAX_N = 1LL << 26;

// The first j (clamped to [0, n]) at which the parabola at b lies strictly
// below the one at a < b, from N = (d[b] + b^2) - (d[a] + a^2) and
// D = 2 (b - a): floor(N / D) + 1.
__device__ __forceinline__ int64_t first_owned(double N, double D, int64_t n)
{
    const double x = N / D;
    if (!(x < (double)n)) return n;  // also NaN: b never owns a j
    if (x < 0.0) return 0;
    double q = floor(x);             // floor(N / D), off by at most one
    if (q * D > N) q -= 1.0;
    else if ((q + 1.0) * D <= N) q += 1.0;
    const int64_t w = (int64_t)q + 1;
    return w < n ? w : n;
}

// One row's envelope: the stack (entry p at st[p * inner], in the row's
// output), its top in registers with g = d + v^2 and t, the first j it
// owns, and up to CACHE entries below the top (cv[0] the next one down)
// with their d and t.  A push shifts the cache down, a pop shifts it up.
// The cache is topped up from memory once per chunk of CHUNK steps, at a
// point every lane of the warp reaches together, so the warp waits for
// memory once a chunk rather than whenever one of its lanes runs dry.
// I is the index type: int where a row's extent n * inner fits it.
template <typename I>
struct Envelope {
    const float* dr;
    int* st;
    I inner, n;
    I top;        // index of the top entry; -1: empty
    int v_top;
    float d_top;
    double g_top;
    I t_top;
    int cv[CACHE];
    float cd[CACHE];
    I ct[CACHE];  // t of each cached entry (kept by the build only)
    int cn;       // valid cache entries

    __device__ __forceinline__ static double g_of(float d, I v)
    {
        return (double)d + (double)v * (double)v;  // v^2 is exact: one rounding
    }

    // load the entries below the top that the cache lacks, up to
    // min(CACHE, top) of them; with_t: also their t, from the entry below
    // each (the build's pops need it; the sweep does not)
    template <bool with_t>
    __device__ __forceinline__ void top_up()
    {
        const int want = top < (I)CACHE ? (int)top : CACHE;
        if (cn >= want) return;
        int vb = 0;
#pragma unroll
        for (int i = 0; i < CACHE; ++i)
            if (i >= cn && i < want) cv[i] = st[(top - 1 - i) * inner];
        if (with_t && top - 1 - want >= 0) vb = st[(top - 1 - want) * inner];
#pragma unroll
        for (int i = 0; i < CACHE; ++i)
            if (i >= cn && i < want) cd[i] = __ldg(dr + (I)cv[i] * inner);
        if (with_t) {
            const bool bottom = top - 1 - want < 0;
            const float db = bottom ? 0.0f : __ldg(dr + (I)vb * inner);
#pragma unroll
            for (int i = 0; i < CACHE; ++i) {
                if (i >= cn && i < want) {
                    // the entry below cached entry i: cached entry i + 1, or vb
                    const bool last = i + 1 >= want;
                    if (last && bottom) {
                        ct[i] = 0;
                    } else {
                        const int v0 = last ? vb : cv[i + 1 < CACHE ? i + 1 : i];
                        const float d0 = last ? db : cd[i + 1 < CACHE ? i + 1 : i];
                        ct[i] = (I)first_owned(g_of(cd[i], cv[i]) - g_of(d0, v0),
                                               2.0 * (double)(cv[i] - v0), n);
                    }
                }
            }
        }
        cn = want;
    }

    // drop the top: the entry below it becomes the top (top > 0, cn > 0)
    __device__ __forceinline__ void step_down()
    {
        --top;
        v_top = cv[0];
        d_top = cd[0];
        g_top = g_of(d_top, v_top);
        t_top = ct[0];
#pragma unroll
        for (int i = 0; i + 1 < CACHE; ++i) {
            cv[i] = cv[i + 1];
            cd[i] = cd[i + 1];
            ct[i] = ct[i + 1];
        }
        --cn;
    }

    // N and D of the boundary between the top and the entry below it
    // (top > 0, cn > 0): that entry keeps every j <= N / D
    __device__ __forceinline__ double n_below() const { return g_top - g_of(cd[0], cv[0]); }
    __device__ __forceinline__ double d_below() const { return 2.0 * (double)(v_top - cv[0]); }

    __device__ __forceinline__ void push(I u, float du, double gu, I t)
    {
        if (top >= 0) {
#pragma unroll
            for (int i = CACHE - 1; i > 0; --i) {
                cv[i] = cv[i - 1];
                cd[i] = cd[i - 1];
                ct[i] = ct[i - 1];
            }
            cv[0] = v_top;
            cd[0] = d_top;
            ct[0] = t_top;
            cn = cn < CACHE ? cn + 1 : CACHE;
        }
        ++top;
        st[top * inner] = (int)u;
        v_top = (int)u;
        d_top = du;
        g_top = gu;
        t_top = t;
    }

    // build step for vertex u: pop every top whose first j u owns, then
    // push u if it owns a j < n
    __device__ __forceinline__ void add(I u, float du)
    {
        const double gu = g_of(du, u);
        double N, D;
        for (;;) {
            N = gu - g_top;
            D = 2.0 * (double)(u - v_top);
            if (!(N < (double)t_top * D)) break;  // u does not own t_top
            if (top == 0) {                       // u owns every j so far
                top = -1;
                cn = 0;
                push(u, du, gu, 0);
                return;
            }
            if (cn == 0) top_up<true>();  // a run of pops deeper than the cache
            step_down();
        }
        if (N < (double)(n - 1) * D) push(u, du, gu, (I)first_owned(N, D, n));
    }
};

template <typename I>
__global__ void __launch_bounds__(THREADS)
edt_pass_kernel(const float* __restrict__ d, float* __restrict__ out,
                int64_t rows, int64_t n64, int64_t inner64)
{
    const int64_t r = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (r >= rows) return;
    const int64_t base = (r / inner64) * n64 * inner64 + (r % inner64);
    const float* dr = d + base;
    float* o = out + base;
    const I n = (I)n64, inner = (I)inner64;

    Envelope<I> e;
    e.dr = dr;
    e.st = reinterpret_cast<int*>(o);
    e.inner = inner;
    e.n = n;
    e.top = 0;
    e.v_top = 0;
    e.d_top = __ldg(dr);
    e.g_top = e.d_top;
    e.t_top = 0;
    e.cn = 0;
    e.st[0] = 0;

    // 1. build, in chunks of CHUNK: the next chunk's d loading meanwhile,
    // the cache topped up at the start of each
    float buf[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c)
        buf[c] = 1 + c < n ? __ldg(dr + (I)(1 + c) * inner) : 0.0f;
    for (I u0 = 1; u0 < n; u0 += CHUNK) {
        float nxt[CHUNK];
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
            const I k = u0 + CHUNK + c;
            nxt[c] = k < n ? __ldg(dr + k * inner) : 0.0f;
        }
        e.template top_up<true>();
#pragma unroll
        for (int c = 0; c < CHUNK; ++c)
            if (u0 + c < n) e.add(u0 + c, buf[c]);
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) buf[c] = nxt[c];
    }

    // 2. sweep j downwards, in chunks of CHUNK (at most one step down per
    // j, since each vertex owns a j, so a chunk needs at most CHUNK cached
    // entries): step down where the entry below keeps j (j <= N / D, the
    // test the build's t stands for, without a division).  The entries a
    // top-up reads sit below the current vertex p, at indices < p <=
    // t[p] <= j: not yet overwritten by out[j + 1 ..]
    for (I j0 = n - 1; j0 >= 0; j0 -= CHUNK) {
        e.template top_up<false>();
        double N = e.top > 0 ? e.n_below() : 0.0;
        double D = e.top > 0 ? e.d_below() : 1.0;
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
            const I j = j0 - c;
            if (j < 0) break;
            if (e.top > 0 && N >= (double)j * D) {
                e.step_down();
                if (e.cn > 0) {
                    N = e.n_below();
                    D = e.d_below();
                }
            }
            const float dj = (float)(j - e.v_top);
            o[j * inner] = __fadd_rn(e.d_top, __fmul_rn(dj, dj));
        }
    }
}

}  // namespace

// d, out: contiguous float32 volumes of the same shape, seen as
// [outer, n, inner]; rows = outer * inner; n < 2^26.  Returns
// cudaGetLastError().
extern "C" int edt_pass(const void* d, void* out, long long rows, long long n,
                        long long inner, void* stream)
{
    if (rows <= 0 || n <= 0) return 0;
    const long long blocks = (rows + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL || n >= MAX_N) return (int)cudaErrorInvalidValue;
    if (n * inner < 0x7fffffffLL)
        edt_pass_kernel<int><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)d, (float*)out, rows, n, inner);
    else
        edt_pass_kernel<int64_t><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const float*)d, (float*)out, rows, n, inner);
    return (int)cudaGetLastError();
}

// Priority-flood watershed with compactness and watershed lines, plus the
// fused instance-tile kernel (virtual z-expansion).
//
// Native replacement for the reference's skimage.segmentation.watershed call
// (hcat/segment.py:468-471: connectivity=1, compactness=0.01,
// watershed_line=True, mask-limited, seeded).  Transcription of the
// published raveled priority-flood algorithm (Meyer flooding + the
// compact-watershed priority term of Neubert & Protzel 2014): a pixel's
// flood priority is
//     image[p] + compactness * ||p - source_seed(p)||
// labels are assigned at pop time from the entry's source pixel, and, with
// watershed lines enabled, a popped pixel whose scan finds an already-
// labeled neighbor of a different region becomes a line (label 0) and
// stops flooding at that neighbor.
//
// The exact semantics (marker age order, neighbor scan order, first-wins
// guard, interleaved line check with break) deliberately match
// tests/watershed_oracle.py bit-for-bit so the two can be compared on
// plateaus too — see that file's docstring for the documented choices.
//
// instance_tile3d fuses the per-tile steps of the instance segmenter
// (hcat/segment.py:444-471): z-replication by expand_z, the distance floor,
// the iterated binary mask dilation (== exact taxicab distance <= R, done
// as a two-pass chamfer), the background seed, and the flood — WITHOUT
// materializing the float64 z-expanded arrays the python path repeats
// (image values are read through a virtual accessor).  Only the expanded
// int32 label volume and uint8 mask are allocated.
//
// The volume is [X, Y, Z] C-contiguous int/float arrays; connectivity 1
// means face neighbors (6 in 3D), 2 adds edges, 3 adds corners.
//
// Exposed via a C ABI for ctypes (see hcunet_tpu/ops/watershed.py).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// 24-byte heap entry (prio + age + packed idx/src) — volumes are capped at
// 2^31 voxels (13 GB of int32 labels; far above any watershed tile).
struct Entry {
  double prio;
  long long age;
  int32_t idx;
  int32_t src;
};

inline bool entry_less(const Entry& a, const Entry& b) {
  // min-heap on (priority, age): `a` comes out before `b`
  if (a.prio != b.prio) return a.prio < b.prio;
  return a.age < b.age;
}

// 4-ary min-heap: ~half the cache misses of a binary heap on large queues.
class MinHeap4 {
 public:
  void reserve(size_t n) { v_.reserve(n); }
  bool empty() const { return v_.empty(); }
  const Entry& top() const { return v_[0]; }
  void push(const Entry& e) {
    v_.push_back(e);
    size_t i = v_.size() - 1;
    while (i > 0) {
      size_t p = (i - 1) >> 2;
      if (!entry_less(v_[i], v_[p])) break;
      std::swap(v_[i], v_[p]);
      i = p;
    }
  }
  void pop() {
    Entry last = v_.back();
    v_.pop_back();
    if (v_.empty()) return;
    size_t n = v_.size(), i = 0;
    for (;;) {
      size_t c0 = 4 * i + 1;
      if (c0 >= n) break;
      size_t best = c0;
      size_t cend = std::min(c0 + 4, n);
      for (size_t c = c0 + 1; c < cend; ++c)
        if (entry_less(v_[c], v_[best])) best = c;
      if (!entry_less(v_[best], last)) break;
      v_[i] = v_[best];
      i = best;
    }
    v_[i] = last;
  }

 private:
  std::vector<Entry> v_;
};

struct Offset {
  int dx, dy, dz, m;
};

// Neighbor table for one (dims, connectivity): C-order enumeration,
// stable-sorted by squared distance (the oracle's scan order).
struct NeighborTable {
  std::vector<long long> offs;
  std::vector<int> d[3];
};

NeighborTable neighbor_table(int64_t X, int64_t Y, int64_t Z,
                             int connectivity) {
  (void)X;
  const int64_t sx = Y * Z, sy = Z, sz = 1;
  std::vector<Offset> off_list;
  for (int dx = -1; dx <= 1; ++dx)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dz = -1; dz <= 1; ++dz) {
        int m = dx * dx + dy * dy + dz * dz;
        if (m == 0 || m > connectivity) continue;
        off_list.push_back(Offset{dx, dy, dz, m});
      }
  std::stable_sort(off_list.begin(), off_list.end(),
                   [](const Offset& a, const Offset& b) { return a.m < b.m; });
  NeighborTable nt;
  for (const auto& o : off_list) {
    nt.offs.push_back((long long)o.dx * sx + o.dy * sy + o.dz * sz);
    nt.d[0].push_back(o.dx);
    nt.d[1].push_back(o.dy);
    nt.d[2].push_back(o.dz);
  }
  return nt;
}

// A marker whose in-bounds, in-mask neighbors ALL hold its own label is a
// provable no-op when popped: it re-writes its own label, cannot trigger a
// watershed line (no differently-labeled positive neighbor can ever appear
// next to it — markers are never re-labeled to another positive label, only
// to the LINE sentinel, which is negative), and pushes nothing (every
// neighbor is already nonzero).  Skipping its initial push is therefore
// bit-exact: the surviving pushes keep their relative (priority, age) order
// and the skipped pops touch no state.  With the instance segmenter's
// defaults (distance_floor 0.2 > seed_background_below 0.15) the background
// seed region is one huge equal-priority plateau whose interior is entirely
// such markers — this cuts initial heap traffic from ~plateau volume to
// ~plateau surface.
inline bool marker_active(const int32_t* output, const uint8_t* mask,
                          const NeighborTable& nt, int64_t X, int64_t Y,
                          int64_t Z, long long x, long long y, long long z,
                          long long idx, int32_t lab) {
  const size_t n_off = nt.offs.size();
  for (size_t k = 0; k < n_off; ++k) {
    long long qx = x + nt.d[0][k];
    long long qy = y + nt.d[1][k];
    long long qz = z + nt.d[2][k];
    if (qx < 0 || qx >= X || qy < 0 || qy >= Y || qz < 0 || qz >= Z) continue;
    long long q = idx + nt.offs[k];
    if (mask && !mask[q]) continue;
    if (output[q] != lab) return true;
  }
  return false;
}

// watershed-line pixels are resolved with a sentinel during the flood
// (never re-claimed, never flooded through, and not a "different region"
// for the line test) and emitted as 0 — see tests/watershed_oracle.py.
constexpr int32_t LINE = -2147483647;

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

bool timing_enabled() {
  static bool on = std::getenv("HCUNET_NATIVE_TIMING") != nullptr;
  return on;
}

// Two-pass taxicab chamfer of the complement of `mask_e`, thresholded at
// `radius` (== exact iterated cross dilation).  T=uint8_t saturates at 255:
// a saturated cell can never relax a neighbor below 255 (candidate 256 is
// never < any stored value), so every cell with true distance >= 255 holds
// exactly 255 and any radius <= 254 thresholds exactly — at 4x less scratch
// traffic than int32.  The int32 instantiation keeps the legacy headroom
// for absurd radii.
template <typename T>
int chamfer_dilate(std::vector<uint8_t>& mask_e, int64_t X, int64_t Y,
                   int64_t Ze, int radius) {
  const T INF = sizeof(T) == 1 ? (T)255 : (T)(1 << 29);
  const int64_t ne = (int64_t)mask_e.size();
  std::vector<T> cham;
  try {
    cham.resize(ne);
  } catch (...) {
    return 2;
  }
  const int64_t sx = Y * Ze, sy = Ze;
  for (long long i = 0; i < ne; ++i) cham[i] = mask_e[i] ? 0 : INF;
  // forward raster scan
  for (long long x = 0; x < X; ++x)
    for (long long y = 0; y < Y; ++y) {
      T* row = cham.data() + x * sx + y * sy;
      const T* up = (x > 0) ? row - sx : nullptr;
      const T* left = (y > 0) ? row - sy : nullptr;
      for (long long z = 0; z < Ze; ++z) {
        int d = row[z];
        if (z > 0 && (int)row[z - 1] + 1 < d) d = (int)row[z - 1] + 1;
        if (left && (int)left[z] + 1 < d) d = (int)left[z] + 1;
        if (up && (int)up[z] + 1 < d) d = (int)up[z] + 1;
        row[z] = (T)d;
      }
    }
  // backward raster scan
  for (long long x = X - 1; x >= 0; --x)
    for (long long y = Y - 1; y >= 0; --y) {
      T* row = cham.data() + x * sx + y * sy;
      const T* down = (x < X - 1) ? row + sx : nullptr;
      const T* right = (y < Y - 1) ? row + sy : nullptr;
      for (long long z = Ze - 1; z >= 0; --z) {
        int d = row[z];
        if (z < Ze - 1 && (int)row[z + 1] + 1 < d) d = (int)row[z + 1] + 1;
        if (right && (int)right[z] + 1 < d) d = (int)right[z] + 1;
        if (down && (int)down[z] + 1 < d) d = (int)down[z] + 1;
        row[z] = (T)d;
      }
    }
  for (long long i = 0; i < ne; ++i) mask_e[i] = cham[i] <= radius;
  return 0;
}

// Shared priority flood over an [X, Y, Z] volume whose image values come
// through `img` (long long raveled idx -> double).  `output` carries the
// initial markers (already cleared outside the mask and pushed by the
// caller via `push_markers`), `mask` limits flooding.
template <typename ImageFn>
void flood(const ImageFn& img, int32_t* output, const uint8_t* mask,
           int64_t X, int64_t Y, int64_t Z, const NeighborTable& nt,
           double compactness, int watershed_line, MinHeap4& heap,
           long long age) {
  const int64_t sx = Y * Z, sy = Z;

  const std::vector<long long>& offs = nt.offs;
  const std::vector<int>* d_ = nt.d;
  const size_t n_off = offs.size();

  auto coords = [&](long long idx, long long& x, long long& y, long long& z) {
    x = idx / sx;
    y = (idx % sx) / sy;
    z = idx % sy;
  };

  long long px, py, pz, qx, qy, qz, sxx, syy, szz;
  while (!heap.empty()) {
    Entry e = heap.top();
    heap.pop();
    // first-wins: already resolved (and not its own marker) => skip
    if (output[e.idx] != 0 && e.idx != e.src) continue;
    const int32_t lab = output[e.src];
    if (lab <= 0) continue;  // source marker became a line: drop its flood
    output[e.idx] = lab;

    coords(e.idx, px, py, pz);
    coords(e.src, sxx, syy, szz);
    for (size_t k = 0; k < n_off; ++k) {
      qx = px + d_[0][k];
      qy = py + d_[1][k];
      qz = pz + d_[2][k];
      if (qx < 0 || qx >= X || qy < 0 || qy >= Y || qz < 0 || qz >= Z) continue;
      long long q = e.idx + offs[k];
      if (mask && !mask[q]) continue;
      if (watershed_line && output[q] > 0 && output[q] != lab) {
        // an already-labeled neighbor of another region: this pixel is a
        // watershed line; stop flooding from it (earlier neighbors in scan
        // order were already pushed — same as the oracle).
        output[e.idx] = LINE;
        break;
      }
      if (output[q] != 0) continue;
      double prio = img(q);
      if (compactness > 0) {
        double ddx = (double)(qx - sxx), ddy = (double)(qy - syy),
               ddz = (double)(qz - szz);
        prio += compactness * std::sqrt(ddx * ddx + ddy * ddy + ddz * ddz);
      }
      heap.push(Entry{prio, age++, (int32_t)q, e.src});
    }
  }
}

}  // namespace

extern "C" {

// image: float64[n], markers(in/out): int32[n], mask: uint8[n]
// dims: int64[3] (X, Y, Z); set Z=1 for 2D.
// Returns 0 on success.
int watershed3d(const double* image, int32_t* output, const uint8_t* mask,
                const int64_t* dims, int connectivity, double compactness,
                int watershed_line) {
  const int64_t X = dims[0], Y = dims[1], Z = dims[2];
  const int64_t n = X * Y * Z;
  if (n >= (int64_t)1 << 31) return 3;

  MinHeap4 heap;
  long long age = 0;
  NeighborTable nt = neighbor_table(X, Y, Z, connectivity);

  // markers outside the mask are cleared first (the activity filter below
  // reads neighbor labels post-clear), then the remaining markers are
  // pushed in raveled order with strictly increasing ages — skipping
  // provable-no-op interior markers (see marker_active; bit-exact).
  for (long long i = 0; i < n; ++i)
    if (mask && !mask[i]) output[i] = 0;
  long long i = 0;
  for (long long x = 0; x < X; ++x)
    for (long long y = 0; y < Y; ++y)
      for (long long z = 0; z < Z; ++z, ++i) {
        int32_t lab = output[i];
        if (lab == 0) continue;
        if (marker_active(output, mask, nt, X, Y, Z, x, y, z, i, lab))
          heap.push(Entry{image[i], age++, (int32_t)i, (int32_t)i});
      }

  flood([image](long long i) { return image[i]; }, output, mask, X, Y, Z,
        nt, compactness, watershed_line, heap, age);

  for (long long i = 0; i < n; ++i)
    if (output[i] == LINE) output[i] = 0;
  return 0;
}

// Fused instance-segmentation tile (hcat/segment.py:444-480 semantics):
// given UNEXPANDED [X, Y, Z] inputs, computes — without materializing the
// float64 expanded volumes — the exact equivalent of
//
//     dist_e = repeat(distance, expand_z, axis=2)
//     seed_e = repeat(seed, expand_z, axis=2)
//     mask_e = repeat(binary, expand_z, axis=2)
//     dist_e[dist_e < distance_floor] = 0
//     mask_e = binary_dilation(mask_e, iterations=expand_mask)   (cross SE)
//     seed_e[dist_e < seed_background_below] = 1
//     labels_e = watershed3d(-dist_e, seed_e, mask_e, conn, comp, line=1)
//     labels_out = labels_e[:, :, ::expand_z]
//
// distance: float64[X*Y*Z]; binary: uint8; seed: int32; labels_out: int32.
// Returns 0 on success, nonzero on bad arguments / allocation failure.
int instance_tile3d(const double* distance, const uint8_t* binary,
                    const int32_t* seed, int32_t* labels_out,
                    const int64_t* dims, int expand_z, int expand_mask,
                    double distance_floor, double seed_background_below,
                    int connectivity, double compactness,
                    int watershed_line) {
  const int64_t X = dims[0], Y = dims[1], Z = dims[2];
  if (expand_z < 1) return 1;
  const int64_t Ze = Z * expand_z;
  const int64_t ne = X * Y * Ze;
  if (ne >= (int64_t)1 << 31) return 3;
  const int E = expand_z;
  const bool tim = timing_enabled();
  double t0 = tim ? now_s() : 0.0;

  // expanded image accessor: floored, negated replicate of `distance`
  auto img = [&](long long ie) {
    long long col = ie / Ze;          // x * Y + y
    long long z = (ie % Ze) / E;      // original z
    double v = distance[col * Z + z];
    if (v < distance_floor) v = 0.0;
    return -v;
  };

  // --- expanded mask: z-replication then iterated cross dilation, done as
  // an exact two-pass taxicab chamfer (L1 distance <= expand_mask) ---
  std::vector<uint8_t> mask_e;
  try {
    mask_e.resize(ne);
  } catch (...) {
    return 2;
  }
  for (long long col = 0; col < X * Y; ++col) {
    const uint8_t* src = binary + col * Z;
    uint8_t* dst = mask_e.data() + col * Ze;
    for (long long z = 0; z < Z; ++z)
      std::memset(dst + z * E, src[z] ? 1 : 0, E);
  }
  if (expand_mask > 0) {
    int rc = (expand_mask <= 254)
                 ? chamfer_dilate<uint8_t>(mask_e, X, Y, Ze, expand_mask)
                 : chamfer_dilate<int32_t>(mask_e, X, Y, Ze, expand_mask);
    if (rc != 0) return rc;
  }
  if (tim) {
    fprintf(stderr, "[instance_tile3d] chamfer dilation: %.3fs\n",
            now_s() - t0);
    t0 = now_s();
  }

  // --- expanded label volume: replicated seeds + background seed where the
  // (floored) height is below seed_background_below; markers outside the
  // mask are cleared; pushes happen in expanded raveled order (ages match
  // the materialized path bit-for-bit) ---
  std::vector<int32_t> out_e;
  try {
    out_e.resize(ne);
  } catch (...) {
    return 2;
  }
  // pass 1: write every expanded label (markers outside the mask cleared) —
  // iterate (col, z, r) nested: expanded raveled order without divisions
  long long ie = 0;
  for (long long col = 0; col < X * Y; ++col) {
    const double* dcol = distance + col * Z;
    const int32_t* scol = seed + col * Z;
    for (long long z = 0; z < Z; ++z) {
      double v = dcol[z];
      if (v < distance_floor) v = 0.0;
      int32_t lab = scol[z];
      if (v < seed_background_below) lab = 1;
      for (int r = 0; r < E; ++r, ++ie)
        out_e[ie] = mask_e[ie] ? lab : 0;
    }
  }
  // pass 2: push markers in the same raveled order, skipping provable
  // no-op interior markers (marker_active — bit-exact; the filter reads
  // neighbor labels, so it needs pass 1 complete)
  MinHeap4 heap;
  heap.reserve(1 << 20);
  long long age = 0;
  NeighborTable nt = neighbor_table(X, Y, Ze, connectivity);
  ie = 0;
  for (long long x = 0; x < X; ++x) {
    for (long long y = 0; y < Y; ++y) {
      const long long col = x * Y + y;
      const double* dcol = distance + col * Z;
      for (long long z = 0; z < Z; ++z) {
        double v = dcol[z];
        if (v < distance_floor) v = 0.0;
        const double nv = -v;
        const long long ze0 = z * E;
        for (int r = 0; r < E; ++r, ++ie) {
          const int32_t lab = out_e[ie];
          if (lab == 0) continue;
          if (marker_active(out_e.data(), mask_e.data(), nt, X, Y, Ze, x, y,
                            ze0 + r, ie, lab))
            heap.push(Entry{nv, age++, (int32_t)ie, (int32_t)ie});
        }
      }
    }
  }
  if (tim) {
    fprintf(stderr, "[instance_tile3d] seed init: %.3fs (%lld pushed)\n",
            now_s() - t0, age);
    t0 = now_s();
  }

  flood(img, out_e.data(), mask_e.data(), X, Y, Ze, nt, compactness,
        watershed_line, heap, age);
  if (tim) {
    fprintf(stderr, "[instance_tile3d] flood: %.3fs\n", now_s() - t0);
    t0 = now_s();
  }

  // decimate z back (replica r=0), resolving line sentinels to 0
  for (long long col = 0; col < X * Y; ++col) {
    const int32_t* src = out_e.data() + col * Ze;
    int32_t* dst = labels_out + col * Z;
    for (long long z = 0; z < Z; ++z) {
      int32_t v = src[z * E];
      dst[z] = (v == LINE) ? 0 : v;
    }
  }
  return 0;
}

// Connected-component labeling (faces connectivity), uint8 in, int32 out.
int label3d(const uint8_t* binary, int32_t* out, const int64_t* dims) {
  const int64_t X = dims[0], Y = dims[1], Z = dims[2];
  const int64_t n = X * Y * Z;
  const int64_t sx = Y * Z, sy = Z;
  std::memset(out, 0, n * sizeof(int32_t));
  int32_t next = 0;
  std::vector<long long> stack;
  for (long long i = 0; i < n; ++i) {
    if (!binary[i] || out[i]) continue;
    ++next;
    stack.push_back(i);
    out[i] = next;
    while (!stack.empty()) {
      long long p = stack.back();
      stack.pop_back();
      long long x = p / sx, y = (p % sx) / sy, z = p % sy;
      const long long nb[6][4] = {
          {x - 1, y, z, p - sx}, {x + 1, y, z, p + sx}, {x, y - 1, z, p - sy},
          {x, y + 1, z, p + sy}, {x, y, z - 1, p - 1},  {x, y, z + 1, p + 1},
      };
      for (auto& q : nb) {
        if (q[0] < 0 || q[0] >= X || q[1] < 0 || q[1] >= Y || q[2] < 0 ||
            q[2] >= Z)
          continue;
        if (binary[q[3]] && !out[q[3]]) {
          out[q[3]] = next;
          stack.push_back(q[3]);
        }
      }
    }
  }
  return next;
}

}  // extern "C"

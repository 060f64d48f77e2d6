// fbpr_native — host-side native runtime (the PyTorch port's copy of the
// JAX package's native/src/fbpr_native.cpp; the code is unchanged).
//
// The reference's runtime is C++ throughout (PCL voxel grids, PCD IO,
// ROS data plumbing).  The rebuild keeps the compute path on the device but
// the host-side data plane — map preparation, dataset decoding, checkpoint
// IO — is native here too:
//
//   * voxel_downsample:   open-addressing hash-grid centroid filter
//                         (pcl::VoxelGrid equivalent, ref usage:
//                          src/mapOptmization.h:190-193)
//   * pcd_read_header/pcd_read_xyzi: PCD v0.7 parser (binary + ascii),
//                         the reference's map checkpoint format
//                         (ref: src/mapOptmization.h:245-260,485-521)
//   * kitti_read_bin:     KITTI velodyne .bin decoder with VLP/HDL ring
//                         inference (replaces config/doc/kitti2bag's role of
//                         manufacturing test input)
//   * crop_box:           axis-aligned box filter (pcl::CropBox equivalent,
//                         ref: src/mapOptmization.h:283-304)
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <condition_variable>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- voxel grid
// Returns number of voxels written (<= cap). Centroids in out_xyz[cap*3].
int64_t voxel_downsample(const float* xyz, int64_t n, float leaf,
                         float* out_xyz, int64_t cap) {
  if (n <= 0 || leaf <= 0.f) return 0;
  const float inv = 1.0f / leaf;

  // open-addressing hash table sized to the next pow2 >= 2n
  int64_t table_size = 1;
  while (table_size < 2 * n) table_size <<= 1;
  const int64_t mask = table_size - 1;

  std::vector<int64_t> keys(table_size, INT64_MIN);
  std::vector<double> sums(table_size * 3, 0.0);
  std::vector<int32_t> counts(table_size, 0);
  std::vector<int64_t> order;  // slots in first-seen order
  order.reserve(n);

  for (int64_t i = 0; i < n; ++i) {
    const float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
    const int64_t ix = (int64_t)std::floor(x * inv);
    const int64_t iy = (int64_t)std::floor(y * inv);
    const int64_t iz = (int64_t)std::floor(z * inv);
    // pack 21 bits per axis (+- ~1e6 cells)
    const int64_t key = ((ix & 0x1FFFFF) << 42) | ((iy & 0x1FFFFF) << 21) |
                        (iz & 0x1FFFFF);
    uint64_t h = (uint64_t)key * 0x9E3779B97F4A7C15ull;
    int64_t slot = (int64_t)(h & (uint64_t)mask);
    while (true) {
      if (keys[slot] == key) break;
      if (keys[slot] == INT64_MIN) {
        keys[slot] = key;
        order.push_back(slot);
        break;
      }
      slot = (slot + 1) & mask;
    }
    sums[slot * 3] += x;
    sums[slot * 3 + 1] += y;
    sums[slot * 3 + 2] += z;
    counts[slot]++;
  }

  const int64_t n_out = (int64_t)order.size() < cap ? (int64_t)order.size() : cap;
  for (int64_t v = 0; v < n_out; ++v) {
    const int64_t slot = order[v];
    const double c = (double)counts[slot];
    out_xyz[v * 3] = (float)(sums[slot * 3] / c);
    out_xyz[v * 3 + 1] = (float)(sums[slot * 3 + 1] / c);
    out_xyz[v * 3 + 2] = (float)(sums[slot * 3 + 2] / c);
  }
  return n_out;
}

// ----------------------------------------------------------------- crop box
// Writes indices of points inside [center +- half] into out_idx; returns count.
int64_t crop_box(const float* xyz, int64_t n, const float* center,
                 const float* half, int64_t* out_idx, int64_t cap) {
  int64_t m = 0;
  for (int64_t i = 0; i < n && m < cap; ++i) {
    const float dx = std::fabs(xyz[i * 3] - center[0]);
    const float dy = std::fabs(xyz[i * 3 + 1] - center[1]);
    const float dz = std::fabs(xyz[i * 3 + 2] - center[2]);
    if (dx <= half[0] && dy <= half[1] && dz <= half[2]) out_idx[m++] = i;
  }
  return m;
}

// ------------------------------------------------------------------ PCD I/O
// Parse header; returns n_points, sets is_binary, x/y/z/intensity byte
// offsets within a record and the record stride. Returns -1 on failure.
int64_t pcd_read_header(const char* path, int32_t* is_binary,
                        int32_t* offsets /*[4]*/, int32_t* stride) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  std::vector<std::string> fields;
  std::vector<int> sizes, counts;
  int64_t n_points = -1;
  *is_binary = 0;
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == '#') continue;
    char key[64];
    if (std::sscanf(line, "%63s", key) != 1) continue;
    std::string k(key);
    const char* rest = line + k.size();
    if (k == "FIELDS") {
      char buf[64];
      int off = 0, used = 0;
      while (std::sscanf(rest + off, "%63s%n", buf, &used) == 1) {
        fields.push_back(buf);
        off += used;
      }
    } else if (k == "SIZE" || k == "COUNT") {
      int v, off = 0, used = 0;
      auto* dst = (k == "SIZE") ? &sizes : &counts;
      while (std::sscanf(rest + off, "%d%n", &v, &used) == 1) {
        dst->push_back(v);
        off += used;
      }
    } else if (k == "POINTS") {
      std::sscanf(rest, "%lld", (long long*)&n_points);
    } else if (k == "DATA") {
      char mode[32];
      std::sscanf(rest, "%31s", mode);
      *is_binary = (std::strcmp(mode, "binary") == 0) ? 1 : 0;
      break;
    }
  }
  std::fclose(f);
  if (n_points < 0 || fields.empty()) return -1;
  if (counts.empty()) counts.assign(fields.size(), 1);

  int s = 0;
  offsets[0] = offsets[1] = offsets[2] = offsets[3] = -1;
  for (size_t i = 0; i < fields.size(); ++i) {
    if (fields[i] == "x") offsets[0] = s;
    if (fields[i] == "y") offsets[1] = s;
    if (fields[i] == "z") offsets[2] = s;
    if (fields[i] == "intensity") offsets[3] = s;
    s += sizes[i] * counts[i];
  }
  *stride = s;
  return n_points;
}

// Read xyz (+ intensity if present) into out buffers. Returns points read.
int64_t pcd_read_xyzi(const char* path, float* out_xyz, float* out_i,
                      int64_t cap) {
  int32_t is_binary, offsets[4], stride;
  int64_t n = pcd_read_header(path, &is_binary, offsets, &stride);
  if (n < 0) return -1;
  if (n > cap) n = cap;

  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // skip header (up to and including DATA line)
  char line[1024];
  while (std::fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "DATA", 4) == 0) break;
  }

  if (is_binary) {
    std::vector<char> rec(stride);
    for (int64_t i = 0; i < n; ++i) {
      if (std::fread(rec.data(), 1, stride, f) != (size_t)stride) {
        std::fclose(f);
        return i;
      }
      std::memcpy(&out_xyz[i * 3], rec.data() + offsets[0], 4);
      std::memcpy(&out_xyz[i * 3 + 1], rec.data() + offsets[1], 4);
      std::memcpy(&out_xyz[i * 3 + 2], rec.data() + offsets[2], 4);
      if (out_i) {
        float v = 0.f;
        if (offsets[3] >= 0) std::memcpy(&v, rec.data() + offsets[3], 4);
        out_i[i] = v;
      }
    }
  } else {
    // ascii: column order follows byte offsets / 4 for f32 fields
    for (int64_t i = 0; i < n; ++i) {
      if (!std::fgets(line, sizeof line, f)) {
        std::fclose(f);
        return i;
      }
      float vals[16] = {0};
      int got = std::sscanf(line,
                            "%f %f %f %f %f %f %f %f %f %f %f %f %f %f %f %f",
                            &vals[0], &vals[1], &vals[2], &vals[3], &vals[4],
                            &vals[5], &vals[6], &vals[7], &vals[8], &vals[9],
                            &vals[10], &vals[11], &vals[12], &vals[13],
                            &vals[14], &vals[15]);
      (void)got;
      out_xyz[i * 3] = vals[offsets[0] / 4];
      out_xyz[i * 3 + 1] = vals[offsets[1] / 4];
      out_xyz[i * 3 + 2] = vals[offsets[2] / 4];
      if (out_i) out_i[i] = offsets[3] >= 0 ? vals[offsets[3] / 4] : 0.f;
    }
  }
  std::fclose(f);
  return n;
}

// ------------------------------------------------------------- KITTI reader
// KITTI velodyne .bin: float32 (x, y, z, reflectance) records. Ring is
// inferred from elevation (HDL-64E: 64 rings over [-24.9, 2.0] deg).
int64_t kitti_read_bin(const char* path, float* out_xyz, float* out_i,
                       int32_t* out_ring, float* out_time, int64_t cap,
                       int32_t n_rings, float elev_min_deg,
                       float elev_max_deg, float scan_period) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  float rec[4];
  int64_t i = 0;
  const float lo = elev_min_deg * (float)M_PI / 180.f;
  const float hi = elev_max_deg * (float)M_PI / 180.f;
  while (i < cap && std::fread(rec, 4, 4, f) == 4) {
    out_xyz[i * 3] = rec[0];
    out_xyz[i * 3 + 1] = rec[1];
    out_xyz[i * 3 + 2] = rec[2];
    if (out_i) out_i[i] = rec[3];
    const float r_xy = std::sqrt(rec[0] * rec[0] + rec[1] * rec[1]);
    const float elev = std::atan2(rec[2], r_xy);
    float fr = (elev - lo) / (hi - lo) * (float)(n_rings - 1);
    int32_t ring = (int32_t)std::lround(fr);
    if (ring < 0) ring = -1;          // dropped by the projector's gate
    if (ring >= n_rings) ring = -1;
    if (out_ring) out_ring[i] = ring;
    if (out_time) {
      // azimuth-proportional relative time, as a VLP-16 reports it
      float az = std::atan2(rec[1], rec[0]);
      if (az < 0) az += 2.f * (float)M_PI;
      out_time[i] = az / (2.f * (float)M_PI) * scan_period;
    }
    ++i;
  }
  std::fclose(f);
  return i;
}

// --------------------------------------------------- threaded scan loader
// Background prefetcher for scan sequences: worker threads decode KITTI
// .bin files ahead of the consumer into a bounded ring of reusable
// buffers, delivered strictly in sequence order.  This is the native
// data-plane analog of the reference's ROS bag playback + subscriber
// queue (scans arrive while the previous one is being processed;
// ref: src/imageProjection.cpp:182-226 consumes from cloudQueue) — here
// file IO + decode overlap the TPU solve instead of a callback thread.

struct ScanSlot {
  std::vector<float> xyz, inten, time;
  std::vector<int32_t> ring;
  int64_t n = -2;        // -2 = empty, -1 = read error, >= 0 = point count
  int64_t index = -1;
};

struct ScanLoader {
  std::vector<std::string> paths;
  int64_t cap = 0;
  int32_t n_rings = 64;
  float elev_min_deg = -24.9f, elev_max_deg = 2.0f, scan_period = 0.1f;
  std::vector<ScanSlot> slots;
  std::atomic<int64_t> next_fetch{0};
  int64_t next_serve = 0;
  std::mutex mu;
  std::condition_variable cv_filled, cv_freed;
  std::vector<std::thread> workers;
  bool stop = false;
};

static void scan_loader_worker(ScanLoader* L) {
  const int64_t depth = (int64_t)L->slots.size();
  std::vector<float> xyz(L->cap * 3), inten(L->cap), time(L->cap);
  std::vector<int32_t> ring(L->cap);
  while (true) {
    const int64_t idx = L->next_fetch.fetch_add(1);
    if (idx >= (int64_t)L->paths.size()) break;
    const int64_t n = kitti_read_bin(
        L->paths[idx].c_str(), xyz.data(), inten.data(), ring.data(),
        time.data(), L->cap, L->n_rings, L->elev_min_deg, L->elev_max_deg,
        L->scan_period);
    ScanSlot& slot = L->slots[idx % depth];
    std::unique_lock<std::mutex> lk(L->mu);
    // wait until the ring slot is free AND it is this index's window
    L->cv_freed.wait(lk, [&] {
      return L->stop || (slot.n == -2 && idx < L->next_serve + depth);
    });
    if (L->stop) break;
    const int64_t m = n < 0 ? 0 : n;
    slot.xyz.assign(xyz.begin(), xyz.begin() + m * 3);
    slot.inten.assign(inten.begin(), inten.begin() + m);
    slot.ring.assign(ring.begin(), ring.begin() + m);
    slot.time.assign(time.begin(), time.begin() + m);
    slot.n = n;
    slot.index = idx;
    L->cv_filled.notify_all();
  }
}

ScanLoader* scan_loader_create(const char** paths, int64_t n_paths,
                               int64_t cap_points, int32_t queue_depth,
                               int32_t n_threads, int32_t n_rings,
                               float elev_min_deg, float elev_max_deg,
                               float scan_period) {
  if (n_paths <= 0 || cap_points <= 0 || queue_depth <= 0) return nullptr;
  ScanLoader* L = new ScanLoader();
  L->paths.reserve(n_paths);
  for (int64_t i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  L->cap = cap_points;
  L->n_rings = n_rings;
  L->elev_min_deg = elev_min_deg;
  L->elev_max_deg = elev_max_deg;
  L->scan_period = scan_period;
  L->slots.resize(queue_depth);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > queue_depth) n_threads = queue_depth;
  for (int32_t t = 0; t < n_threads; ++t)
    L->workers.emplace_back(scan_loader_worker, L);
  return L;
}

// Copies the next scan (in sequence order) into the caller's buffers.
// Returns the point count, -1 on a file read error, -2 when exhausted.
int64_t scan_loader_next(ScanLoader* L, float* out_xyz, float* out_i,
                         int32_t* out_ring, float* out_time) {
  if (!L) return -2;
  if (L->next_serve >= (int64_t)L->paths.size()) return -2;
  const int64_t depth = (int64_t)L->slots.size();
  ScanSlot& slot = L->slots[L->next_serve % depth];
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_filled.wait(lk, [&] {
    return slot.n != -2 && slot.index == L->next_serve;
  });
  const int64_t n = slot.n;
  const int64_t m = n < 0 ? 0 : n;
  if (out_xyz) std::memcpy(out_xyz, slot.xyz.data(), m * 3 * sizeof(float));
  if (out_i) std::memcpy(out_i, slot.inten.data(), m * sizeof(float));
  if (out_ring)
    std::memcpy(out_ring, slot.ring.data(), m * sizeof(int32_t));
  if (out_time) std::memcpy(out_time, slot.time.data(), m * sizeof(float));
  slot.n = -2;
  slot.index = -1;
  L->next_serve++;
  L->cv_freed.notify_all();
  return n;
}

void scan_loader_destroy(ScanLoader* L) {
  if (!L) return;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_freed.notify_all();
  L->next_fetch.store((int64_t)L->paths.size());
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"

// Native reference-exact particle engine (C++, OpenMP).
//
// A deterministic transcription of the reference physics core
// (/root/reference/src/lib.rs) used as (a) an independent ground-truth
// oracle for parity tests at N far beyond what the Python loop oracle can
// reach, and (b) a fast host-side CPU fallback engine. It keeps the
// reference's literal architecture — spatial hash with counting sort
// (lib.rs:134-164), 27 periodic world-image sweep (lib.rs:177-191),
// piecewise force law (lib.rs:55-67), Euler + stop-at-zero drag
// (lib.rs:245-262), per-axis wall/wrap handling (lib.rs:70-127) — but
// replaces SipHash bucketing with exact cell keys (collisions in the
// reference only ever add radius-rejected candidates, so semantics are
// identical) and rayon's nondeterministic fold with a fixed accumulation
// order (per-particle serial, particles OpenMP-parallel: Jacobi update
// from a snapshot, so parallelism cannot change results).
//
// Exposed as a C ABI for ctypes (see particle3d/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// lib.rs:55-67 — verbatim branch structure (strict inequalities).
inline float calculate_force(float distance, float attraction,
                             float min_pull_ratio) {
  if (distance < min_pull_ratio) {
    return distance / min_pull_ratio - 1.0f;
  } else if (min_pull_ratio < distance && distance < 1.0f) {
    return attraction * (1.0f - std::fabs(2.0f * distance - 1.0f -
                                          min_pull_ratio) /
                                    (1.0f - min_pull_ratio));
  }
  return 0.0f;
}

// lib.rs:37-43 — truncation toward zero (quirk Q1), kept bug-compatible.
inline long long cell_coord(float v, float radius) {
  return static_cast<long long>(v / radius);
}

struct CellKey {
  long long x, y, z;
  bool operator==(const CellKey& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

inline size_t hash_key(const CellKey& k, size_t buckets) {
  // exact-key open hashing; 64-bit mix then mod (collisions resolved by
  // key comparison, unlike the reference's tolerated SipHash collisions)
  uint64_t h = 1469598103934665603ull;
  auto mix = [&h](uint64_t v) {
    h ^= v + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
  };
  mix(static_cast<uint64_t>(k.x));
  mix(static_cast<uint64_t>(k.y));
  mix(static_cast<uint64_t>(k.z));
  return static_cast<size_t>(h % buckets);
}

}  // namespace

extern "C" {

// One reference-exact Euler step (lib.rs:130-272). Arrays are row-major:
// pos/vel: [n,3] f32 (updated in place), species: [n] u32,
// attraction: [id_count*id_count] f32 row-major (row = self id),
// accel: [3] f32 global gravity. walls != 0 -> clamp boundary, else wrap.
// use_hash != 0 -> spatial-hash neighbor search, else brute force.
void p3d_step(float* pos, float* vel, const uint32_t* species, int64_t n,
              float world_size, int32_t id_count, const float* attraction,
              float coefficient, float interaction_force, float min_pull_ratio,
              float radius, int32_t walls, const float* accel_in, float dt,
              int32_t use_hash) {
  const float r2 = radius * radius;
  const V3 gravity = {accel_in[0], accel_in[1], accel_in[2]};
  const float half = world_size * 0.5f;

  // snapshot (the reference's past_particles, lib.rs:167-171)
  std::vector<V3> past_pos(n), past_vel(n);
  std::memcpy(past_pos.data(), pos, n * sizeof(V3));
  std::memcpy(past_vel.data(), vel, n * sizeof(V3));

  // spatial hash: exact-key chained buckets, counting-sort layout
  std::vector<int64_t> bucket_of(n);
  std::vector<int64_t> starts;
  std::vector<int64_t> order;
  size_t buckets = 0;
  std::vector<CellKey> keys(n);
  std::vector<CellKey> bucket_key;
  if (use_hash && n > 0) {
    buckets = static_cast<size_t>(n) * 2 + 1;
    starts.assign(buckets + 1, 0);
    order.resize(n);
    bucket_key.resize(buckets);
    std::vector<int8_t> bucket_used(buckets, 0);
    for (int64_t i = 0; i < n; ++i) {
      CellKey k{cell_coord(past_pos[i].x, radius),
                cell_coord(past_pos[i].y, radius),
                cell_coord(past_pos[i].z, radius)};
      size_t b = hash_key(k, buckets);
      // linear probe to an exact-key slot
      while (bucket_used[b] && !(bucket_key[b] == k)) b = (b + 1) % buckets;
      bucket_used[b] = 1;
      bucket_key[b] = k;
      keys[i] = k;
      bucket_of[i] = static_cast<int64_t>(b);
      starts[b + 1]++;
    }
    for (size_t b = 0; b < buckets; ++b) starts[b + 1] += starts[b];
    std::vector<int64_t> cursor(starts.begin(), starts.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[bucket_of[i]]++] = i;

    // mark empty buckets' keys as unusable sentinels
    for (size_t b = 0; b < buckets; ++b)
      if (!bucket_used[b]) bucket_key[b] = {INT64_MIN, INT64_MIN, INT64_MIN};
  }

  auto find_bucket = [&](const CellKey& k) -> int64_t {
    size_t b = hash_key(k, buckets);
    for (size_t probe = 0; probe < buckets; ++probe) {
      if (bucket_key[b] == k) return static_cast<int64_t>(b);
      if (bucket_key[b].x == INT64_MIN && starts[b + 1] == starts[b] &&
          !(bucket_key[b] == k))
        return -1;  // empty never-used slot terminates the probe chain
      b = (b + 1) % buckets;
    }
    return -1;
  };

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    V3 p = past_pos[i];
    V3 acc = {0.0f, 0.0f, 0.0f};
    const uint32_t si = species[i];

    // 27 periodic world images, applied regardless of walls (quirk Q3),
    // in the reference's iteration order (lib.rs:177-191)
    for (int xo = -1; xo <= 1; ++xo) {
      for (int yo = -1; yo <= 1; ++yo) {
        for (int zo = -1; zo <= 1; ++zo) {
          const V3 off = {xo * world_size, yo * world_size, zo * world_size};
          const V3 base = p + off;
          if (use_hash && n > 0) {
            const CellKey c0{cell_coord(base.x, radius),
                             cell_coord(base.y, radius),
                             cell_coord(base.z, radius)};
            for (int xc = -1; xc <= 1; ++xc) {
              for (int yc = -1; yc <= 1; ++yc) {
                for (int zc = -1; zc <= 1; ++zc) {
                  const CellKey c{c0.x + xc, c0.y + yc, c0.z + zc};
                  const int64_t b = find_bucket(c);
                  if (b < 0) continue;
                  for (int64_t s = starts[b]; s < starts[b + 1]; ++s) {
                    const int64_t j = order[s];
                    const V3 rel = past_pos[j] - base;
                    const float d2 = dot(rel, rel);
                    if (d2 > 0.0f && d2 < r2) {
                      const float d = std::sqrt(d2);
                      const float f = calculate_force(
                          d, attraction[si * id_count + species[j]],
                          min_pull_ratio);
                      acc = acc + rel * (f / d);
                    }
                  }
                }
              }
            }
          } else {
            for (int64_t j = 0; j < n; ++j) {
              const V3 rel = past_pos[j] - base;
              const float d2 = dot(rel, rel);
              if (d2 > 0.0f && d2 < r2) {
                const float d = std::sqrt(d2);
                const float f = calculate_force(
                    d, attraction[si * id_count + species[j]], min_pull_ratio);
                acc = acc + rel * (f / d);
              }
            }
          }
        }
      }
    }

    // integrate (lib.rs:245-262, exact order)
    V3 v = past_vel[i];
    v = v + acc * (interaction_force * radius * dt);
    v = v + gravity * dt;
    const V3 dv = v * (coefficient * dt);
    if (dot(dv, dv) > dot(v, v)) {
      v = {0.0f, 0.0f, 0.0f};
    } else {
      v = v - dv;
    }
    V3 x = past_pos[i] + v * dt;

    // boundary (lib.rs:70-127)
    float* xc = &x.x;
    float* vc = &v.x;
    for (int a = 0; a < 3; ++a) {
      if (xc[a] > half) {
        if (walls) {
          xc[a] = half;
          vc[a] = vc[a] < 0.0f ? vc[a] : 0.0f;
        } else {
          xc[a] -= world_size;
        }
      } else if (xc[a] < -half) {
        if (walls) {
          xc[a] = -half;
          vc[a] = vc[a] > 0.0f ? vc[a] : 0.0f;
        } else {
          xc[a] += world_size;
        }
      }
    }

    pos[i * 3 + 0] = x.x;
    pos[i * 3 + 1] = x.y;
    pos[i * 3 + 2] = x.z;
    vel[i * 3 + 0] = v.x;
    vel[i * 3 + 1] = v.y;
    vel[i * 3 + 2] = v.z;
  }
}

void p3d_simulate(float* pos, float* vel, const uint32_t* species, int64_t n,
                  float world_size, int32_t id_count, const float* attraction,
                  float coefficient, float interaction_force,
                  float min_pull_ratio, float radius, int32_t walls,
                  const float* accel, float dt, int32_t use_hash,
                  int64_t steps) {
  for (int64_t s = 0; s < steps; ++s) {
    p3d_step(pos, vel, species, n, world_size, id_count, attraction,
             coefficient, interaction_force, min_pull_ratio, radius, walls,
             accel, dt, use_hash);
  }
}

int32_t p3d_abi_version() { return 1; }

}  // extern "C"

// Native track-association engine (host-side runtime component) — a copy
// of radar_tpu/native/tracker.cpp for the PyTorch port.
//
// The inter-frame 5D gate association (SURVEY.md section 2.1 "Inter-frame
// track association"; reference main_simulate_echoes_with_array_v8_3.m:
// 253-335) is host-side O(N^2) BFS over the cumulative detection log. At
// the 10k-target Monte-Carlo scale of BASELINE.json config 5 the dense
// BFS becomes the frame-loop bottleneck, so the runtime ships this C++
// implementation (ctypes-loaded by radar_tpu_torch/native.py).
//
// Semantics are identical to the reference BFS: grow a component from the
// lowest-index unvisited row, adding any row within ALL five absolute-
// difference gates of ANY member; component ids are assigned in first-seen
// order. A spatial hash on (range, frame) buckets prunes the candidate set,
// turning the dense N^2 scan into near-linear work for realistic logs while
// producing exactly the same components.
//
// Build: radar_tpu_torch/_build.py::load_host compiles it with the host
// C++ compiler at first use (c++ -O3 -std=c++17 -fPIC -shared).

#include <cstdint>
#include <cmath>
#include <vector>
#include <unordered_map>

namespace {

struct Gates {
  double r, v, az, el, frame;
};

inline bool within(const double* f, int64_t n, int64_t i, int64_t j,
                   const Gates& g) {
  const double* range = f;
  const double* vel = f + n;
  const double* az = f + 2 * n;
  const double* el = f + 3 * n;
  const double* frame = f + 4 * n;
  return std::fabs(range[i] - range[j]) <= g.r &&
         std::fabs(vel[i] - vel[j]) <= g.v &&
         std::fabs(az[i] - az[j]) <= g.az &&
         std::fabs(el[i] - el[j]) <= g.el &&
         std::fabs(frame[i] - frame[j]) <= g.frame;
}

}  // namespace

extern "C" {

// fields: column-major [5][n] doubles (range, velocity, azimuth, elevation,
// frame). gates: 5 doubles in the same order. out: n int64 component ids.
// Returns the number of components.
int64_t associate_tracks_5d(const double* fields, int64_t n,
                            const double* gates, int64_t* out) {
  if (n <= 0) return 0;
  Gates g{gates[0], gates[1], gates[2], gates[3], gates[4]};
  const double* range = fields;
  const double* frame = fields + 4 * n;

  // bucket rows by (range/gate_r, frame/gate_frame); any gate-compatible
  // pair lands in adjacent buckets
  const double rb = g.r > 0 ? g.r : 1.0;
  const double fb = g.frame > 0 ? g.frame : 1.0;
  std::unordered_map<int64_t, std::vector<int64_t>> buckets;
  buckets.reserve(static_cast<size_t>(n));
  auto bucket_key = [&](int64_t rk, int64_t fk) {
    return rk * 1000003 + fk;
  };
  std::vector<int64_t> rkey(n), fkey(n);
  for (int64_t i = 0; i < n; ++i) {
    rkey[i] = static_cast<int64_t>(std::floor(range[i] / rb));
    fkey[i] = static_cast<int64_t>(std::floor(frame[i] / fb));
    buckets[bucket_key(rkey[i], fkey[i])].push_back(i);
  }

  for (int64_t i = 0; i < n; ++i) out[i] = -1;
  int64_t next_id = 0;
  std::vector<int64_t> stack;
  for (int64_t seed = 0; seed < n; ++seed) {
    if (out[seed] >= 0) continue;
    out[seed] = next_id;
    stack.clear();
    stack.push_back(seed);
    while (!stack.empty()) {
      int64_t u = stack.back();
      stack.pop_back();
      for (int64_t dr = -1; dr <= 1; ++dr) {
        for (int64_t df = -1; df <= 1; ++df) {
          auto it = buckets.find(bucket_key(rkey[u] + dr, fkey[u] + df));
          if (it == buckets.end()) continue;
          for (int64_t cand : it->second) {
            if (out[cand] < 0 && within(fields, n, u, cand, g)) {
              out[cand] = next_id;
              stack.push_back(cand);
            }
          }
        }
      }
    }
    ++next_id;
  }
  return next_id;
}

// Generic dense gate BFS used by the jnp-free host path of the intra/inter
// beam stages at large capacity (k fields, each [n]; gates [k]).
int64_t connected_components_gated(const double* fields, int64_t n,
                                   int64_t k, const double* gates,
                                   int64_t* out) {
  if (n <= 0) return 0;
  for (int64_t i = 0; i < n; ++i) out[i] = -1;
  int64_t next_id = 0;
  std::vector<int64_t> stack;
  for (int64_t seed = 0; seed < n; ++seed) {
    if (out[seed] >= 0) continue;
    out[seed] = next_id;
    stack.clear();
    stack.push_back(seed);
    while (!stack.empty()) {
      int64_t u = stack.back();
      stack.pop_back();
      for (int64_t j = 0; j < n; ++j) {
        if (out[j] >= 0) continue;
        bool ok = true;
        for (int64_t f = 0; f < k && ok; ++f) {
          ok = std::fabs(fields[f * n + u] - fields[f * n + j]) <= gates[f];
        }
        if (ok) {
          out[j] = next_id;
          stack.push_back(j);
        }
      }
    }
    ++next_id;
  }
  return next_id;
}

}  // extern "C"

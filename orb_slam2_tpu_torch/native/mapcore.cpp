// mapcore: native observation / covisibility engine for the SLAM map.
//
// The reference implements its map bookkeeping in C++ pointer graphs
// (MapPoint::mObservations, KeyFrame::UpdateConnections —
// src/MapPoint.cc:98-149, src/KeyFrame.cc:289-380).  Our Python host
// pipeline keeps decisions in Python but the per-keyframe bookkeeping
// (observation maps, covisibility counting, local-keyframe voting,
// distinctive-descriptor selection) is hot enough to need native code.
// This engine owns the point->observations structure; Python holds ids.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 mapcore.cpp -o libmapcore.so
// Binding: ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

struct Obs {
    int32_t kf;
    int32_t feat;
    int32_t weight;   // 2 for stereo observations, 1 mono (nObs semantics)
};

struct Engine {
    // pid -> observation list (small vectors; median size ~4)
    std::unordered_map<int64_t, std::vector<Obs>> obs;
    std::unordered_map<int64_t, int32_t> n_obs;
};

inline std::vector<Obs>* find_obs(Engine* e, int64_t pid) {
    auto it = e->obs.find(pid);
    return it == e->obs.end() ? nullptr : &it->second;
}

}  // namespace

extern "C" {

void* mapcore_create() { return new Engine(); }

void mapcore_destroy(void* h) { delete static_cast<Engine*>(h); }

void mapcore_clear(void* h) {
    auto* e = static_cast<Engine*>(h);
    e->obs.clear();
    e->n_obs.clear();
}

// Returns 1 if added, 0 if (pid, kf) already present.
int mapcore_add_obs(void* h, int64_t pid, int32_t kf, int32_t feat,
                    int32_t weight) {
    auto* e = static_cast<Engine*>(h);
    auto& v = e->obs[pid];
    for (const auto& o : v)
        if (o.kf == kf) return 0;
    v.push_back({kf, feat, weight});
    e->n_obs[pid] += weight;
    return 1;
}

// Batched same-keyframe observation add (the keyframe-insertion hot
// path: hundreds of bound features + born points per keyframe).
// out_added[i] = 1 if row i was inserted, 0 if (pid, kf) was already
// present.  Returns the number inserted.
int mapcore_add_obs_batch(void* h, const int64_t* pids, int32_t kf,
                          const int32_t* feats, const int32_t* weights,
                          int32_t n, uint8_t* out_added) {
    auto* e = static_cast<Engine*>(h);
    int added = 0;
    for (int i = 0; i < n; ++i) {
        auto& v = e->obs[pids[i]];
        bool dup = false;
        for (const auto& o : v)
            if (o.kf == kf) { dup = true; break; }
        if (dup) { out_added[i] = 0; continue; }
        v.push_back({kf, feats[i], weights[i]});
        e->n_obs[pids[i]] += weights[i];
        out_added[i] = 1;
        ++added;
    }
    return added;
}

// Returns the removed feature index, or -1 if absent.
int mapcore_erase_obs(void* h, int64_t pid, int32_t kf) {
    auto* e = static_cast<Engine*>(h);
    auto* v = find_obs(e, pid);
    if (!v) return -1;
    for (size_t i = 0; i < v->size(); ++i) {
        if ((*v)[i].kf == kf) {
            int feat = (*v)[i].feat;
            e->n_obs[pid] -= (*v)[i].weight;
            v->erase(v->begin() + i);
            return feat;
        }
    }
    return -1;
}

void mapcore_clear_point(void* h, int64_t pid) {
    auto* e = static_cast<Engine*>(h);
    e->obs.erase(pid);
    e->n_obs.erase(pid);
}

int mapcore_n_obs(void* h, int64_t pid) {
    auto* e = static_cast<Engine*>(h);
    auto it = e->n_obs.find(pid);
    return it == e->n_obs.end() ? 0 : it->second;
}

int mapcore_count(void* h, int64_t pid) {
    auto* v = find_obs(static_cast<Engine*>(h), pid);
    return v ? (int)v->size() : 0;
}

// Fill out_kf/out_feat with the observers of pid; returns count written.
int mapcore_get_obs(void* h, int64_t pid, int32_t* out_kf,
                    int32_t* out_feat, int32_t cap) {
    auto* v = find_obs(static_cast<Engine*>(h), pid);
    if (!v) return 0;
    int n = std::min((int)v->size(), (int)cap);
    for (int i = 0; i < n; ++i) {
        out_kf[i] = (*v)[i].kf;
        out_feat[i] = (*v)[i].feat;
    }
    return n;
}

// Batched observation dump: for each pid in `pids` write one row per
// observation (index into `pids`, observing kf, feature) into the out
// arrays.  Returns the number of rows written (truncated at cap).
// Powers vectorized MapPoint updates (normal/depth/scale bands) after
// bundle adjustment, replacing per-point Python loops.
int mapcore_dump_obs(void* h, const int64_t* pids, int32_t n,
                     int32_t* out_idx, int32_t* out_kf, int32_t* out_feat,
                     int32_t cap) {
    auto* e = static_cast<Engine*>(h);
    int m = 0;
    for (int32_t i = 0; i < n; ++i) {
        auto* v = find_obs(e, pids[i]);
        if (!v) continue;
        for (const auto& o : *v) {
            if (m >= cap) return m;
            out_idx[m] = i;
            out_kf[m] = o.kf;
            out_feat[m] = o.feat;
            ++m;
        }
    }
    return m;
}

// Does kf observe pid?  Returns feature index or -1.
int mapcore_find(void* h, int64_t pid, int32_t kf) {
    auto* v = find_obs(static_cast<Engine*>(h), pid);
    if (!v) return -1;
    for (const auto& o : *v)
        if (o.kf == kf) return o.feat;
    return -1;
}

// Covisibility / voting core: given a list of point ids, count how many
// of them each keyframe observes (KeyFrame::UpdateConnections counting
// loop and Tracking::UpdateLocalKeyFrames voting, the per-frame hot
// path).  exclude_kf < 0 disables exclusion.  Results are written as
// (kf, count) pairs sorted by descending count; returns the number of
// pairs (truncated at cap).
int mapcore_count_observers(void* h, const int64_t* pids, int32_t n,
                            int32_t exclude_kf, int32_t* out_kf,
                            int32_t* out_count, int32_t cap) {
    auto* e = static_cast<Engine*>(h);
    std::unordered_map<int32_t, int32_t> counter;
    counter.reserve(256);
    for (int i = 0; i < n; ++i) {
        if (pids[i] < 0) continue;
        auto* v = find_obs(e, pids[i]);
        if (!v) continue;
        for (const auto& o : *v)
            if (o.kf != exclude_kf) ++counter[o.kf];
    }
    std::vector<std::pair<int32_t, int32_t>> items(counter.begin(),
                                                   counter.end());
    std::sort(items.begin(), items.end(),
              [](const auto& a, const auto& b) {
                  return a.second > b.second ||
                         (a.second == b.second && a.first < b.first);
              });
    int m = std::min((int)items.size(), (int)cap);
    for (int i = 0; i < m; ++i) {
        out_kf[i] = items[i].first;
        out_count[i] = items[i].second;
    }
    return m;
}

// Distinctive descriptor: index of the descriptor with minimum median
// Hamming distance to the others (MapPoint::ComputeDistinctiveDescriptors,
// src/MapPoint.cc:242-307).  descs: n x 8 uint32 rows.
int mapcore_distinctive(const uint32_t* descs, int32_t n) {
    if (n <= 1) return 0;
    std::vector<int> dist(n * n, 0);
    for (int i = 0; i < n; ++i) {
        for (int j = i + 1; j < n; ++j) {
            int d = 0;
            for (int k = 0; k < 8; ++k)
                d += __builtin_popcount(descs[i * 8 + k] ^
                                        descs[j * 8 + k]);
            dist[i * n + j] = d;
            dist[j * n + i] = d;
        }
    }
    int best = 0, best_median = 1 << 30;
    std::vector<int> row(n);
    for (int i = 0; i < n; ++i) {
        std::memcpy(row.data(), &dist[i * n], n * sizeof(int));
        std::sort(row.begin(), row.end());
        int median = row[(n - 1) / 2 + ((n - 1) % 2)];  // row[ceil((n-1)/2)]
        if (median < best_median) {
            best_median = median;
            best = i;
        }
    }
    return best;
}

// Segmented batch of mapcore_distinctive: descs holds concatenated
// per-point descriptor groups (rows of 8 uint32); segment i spans
// [seg_start[i], seg_start[i] + seg_len[i]).  Writes the distinctive
// row index WITHIN each segment to out_idx.  Replaces the per-point
// Python loop in the post-fusion map-point refresh.
void mapcore_distinctive_batch(const uint32_t* descs,
                               const int32_t* seg_start,
                               const int32_t* seg_len, int32_t n_segs,
                               int32_t* out_idx) {
    for (int32_t s = 0; s < n_segs; ++s)
        out_idx[s] = mapcore_distinctive(descs + (int64_t)seg_start[s] * 8,
                                         seg_len[s]);
}

// Bresenham-style visited/occupied accumulation for the occupancy grid
// (ros_mono_sub.cc:219-300).  Rays from start to each cell; grids are
// HxW float32 row-major.
void mapcore_raycast(float* visited, float* occupied, int32_t gh,
                     int32_t gw, int32_t sx, int32_t sz,
                     const int64_t* cells, int32_t n) {
    for (int i = 0; i < n; ++i) {
        int ex = (int)cells[2 * i];
        int ez = (int)cells[2 * i + 1];
        if (ex < 0 || ex >= gw || ez < 0 || ez >= gh) continue;
        occupied[ez * gw + ex] += 1.0f;
        int dx = ex - sx, dz = ez - sz;
        int steps = std::max(std::abs(dx), std::abs(dz));
        if (steps == 0) {
            visited[ez * gw + ex] += 1.0f;
            continue;
        }
        float fx = (float)dx / steps, fz = (float)dz / steps;
        for (int s = 0; s <= steps; ++s) {
            int cx = (int)std::lround(sx + fx * s);
            int cz = (int)std::lround(sz + fz * s);
            if (cx >= 0 && cx < gw && cz >= 0 && cz < gh)
                visited[cz * gw + cx] += 1.0f;
        }
    }
}

}  // extern "C"

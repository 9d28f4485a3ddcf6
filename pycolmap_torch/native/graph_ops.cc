// Native correspondence-graph traversal kernels (host C++).
//
// Copy of pycolmap_tpu/native/graph_ops.cc for the PyTorch port (its
// min-cut's max-flow replaced, see graph_min_cut): the counterpart of the reference's C++ scene/correspondence_graph.cc hot
// paths, breadth-first expansion over the CSR adjacency used by
// transitive-correspondence extraction
// (ref: pycolmap/scene/correspondence_graph.h:76-77) and track completion
// (upstream IncrementalTriangulator::Complete). These traversals are
// irreducibly serial per source node and dominate host time for large
// scenes, so they live in C++; arrays come in as raw pointers from numpy
// via ctypes (no Python API dependency).
//
// Build (pycolmap_torch/native/__init__.py does it at first use, into
// build/pycolmap_torch/graph_ops-<hash>/):
//   c++ -O3 -shared -fPIC graph_ops.cc -o libgraph_ops.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

extern "C" {

// BFS from `start` up to `transitivity` hops. Writes visited nodes
// (excluding start) into `out` (capacity out_cap); returns count.
// visited: caller-provided scratch of num_nodes bytes, zeroed on entry and
// re-zeroed on exit (touched entries only).
int64_t bfs_transitive(const int64_t* indptr, const int64_t* adj,
                       int64_t num_nodes, int64_t start, int32_t transitivity,
                       int64_t* out, int64_t out_cap, uint8_t* visited) {
  if (start < 0 || start >= num_nodes) return 0;
  std::vector<int64_t> frontier{start};
  std::vector<int64_t> next;
  visited[start] = 1;
  int64_t count = 0;
  for (int32_t hop = 0; hop < transitivity && !frontier.empty(); ++hop) {
    next.clear();
    for (int64_t node : frontier) {
      for (int64_t e = indptr[node]; e < indptr[node + 1]; ++e) {
        int64_t nb = adj[e];
        if (!visited[nb]) {
          visited[nb] = 1;
          if (count < out_cap) out[count] = nb;
          ++count;
          next.push_back(nb);
        }
      }
    }
    frontier.swap(next);
  }
  // reset scratch (only touched entries)
  visited[start] = 0;
  for (int64_t i = 0; i < (count < out_cap ? count : out_cap); ++i) {
    visited[out[i]] = 0;
  }
  // frontier/next nodes are all recorded in out already
  return count;
}

// Batched BFS from multiple seed nodes treated as one connected component
// (used by track completion: seeds = the track's current observations).
// eligible[node] != 0 marks nodes that may be traversed THROUGH and
// reported; ineligible nodes are recorded as blocked (not expanded).
// Returns number of reported nodes written to out (with their hop depth in
// out_depth).
int64_t bfs_component(const int64_t* indptr, const int64_t* adj,
                      int64_t num_nodes, const int64_t* seeds,
                      int64_t num_seeds, int32_t max_depth,
                      const uint8_t* eligible, int64_t* out,
                      int32_t* out_depth, int64_t out_cap, uint8_t* visited) {
  std::vector<int64_t> frontier;
  frontier.reserve(num_seeds);
  for (int64_t i = 0; i < num_seeds; ++i) {
    int64_t s = seeds[i];
    if (s >= 0 && s < num_nodes && !visited[s]) {
      visited[s] = 1;
      frontier.push_back(s);
    }
  }
  std::vector<int64_t> next;
  std::vector<int64_t> touched(frontier);
  int64_t count = 0;
  for (int32_t hop = 1; hop <= max_depth && !frontier.empty(); ++hop) {
    next.clear();
    for (int64_t node : frontier) {
      for (int64_t e = indptr[node]; e < indptr[node + 1]; ++e) {
        int64_t nb = adj[e];
        if (visited[nb]) continue;
        visited[nb] = 1;
        touched.push_back(nb);
        if (eligible[nb]) {
          if (count < out_cap) {
            out[count] = nb;
            out_depth[count] = hop;
          }
          ++count;
          next.push_back(nb);
        }
      }
    }
    frontier.swap(next);
  }
  for (int64_t node : touched) visited[node] = 0;
  return count;
}

// Track-completion candidate expansion (the hot loop of upstream
// IncrementalTriangulator::Complete): for every edge of the given source
// nodes, emit (target_node, source_pid) where the target keypoint is
// unlinked and its image registered — deduped by target, first pid wins.
// visited: num_nodes scratch, zero on entry, re-zeroed on exit.
int64_t expand_complete_candidates(
    const int64_t* indptr, const int64_t* adj, const int32_t* node_image,
    const int64_t* flat_pid, const uint8_t* reg_flag,
    const int64_t* src_nodes, int64_t n_src, int64_t* out_tgt,
    int64_t* out_pid, int64_t out_cap, uint8_t* visited) {
  int64_t count = 0;
  for (int64_t i = 0; i < n_src; ++i) {
    const int64_t node = src_nodes[i];
    const int64_t pid = flat_pid[node];
    for (int64_t e = indptr[node]; e < indptr[node + 1]; ++e) {
      const int64_t tgt = adj[e];
      if (visited[tgt]) continue;
      if (flat_pid[tgt] >= 0) continue;
      if (!reg_flag[node_image[tgt]]) continue;
      visited[tgt] = 1;
      if (count < out_cap) {
        out_tgt[count] = tgt;
        out_pid[count] = pid;
      }
      ++count;
    }
  }
  const int64_t n = count < out_cap ? count : out_cap;
  for (int64_t i = 0; i < n; ++i) visited[out_tgt[i]] = 0;
  return count;
}

// Merge candidate expansion (upstream MergeAllTracks): unique (min, max)
// point-id pairs joined by an edge whose two endpoints link different
// points. Dedup via sort of packed 64-bit codes (pids < 2^32).
int64_t expand_merge_pairs(
    const int64_t* indptr, const int64_t* adj, const int64_t* flat_pid,
    const int64_t* src_nodes, int64_t n_src, int64_t* out_codes,
    int64_t out_cap) {
  int64_t count = 0;
  for (int64_t i = 0; i < n_src; ++i) {
    const int64_t node = src_nodes[i];
    const int64_t spid = flat_pid[node];
    for (int64_t e = indptr[node]; e < indptr[node + 1]; ++e) {
      const int64_t tpid = flat_pid[adj[e]];
      if (tpid < 0 || tpid == spid) continue;
      const int64_t a = spid < tpid ? spid : tpid;
      const int64_t b = spid < tpid ? tpid : spid;
      if (count < out_cap) out_codes[count] = (a << 32) | b;
      ++count;
    }
  }
  const int64_t n = count < out_cap ? count : out_cap;
  std::sort(out_codes, out_codes + n);
  return std::unique(out_codes, out_codes + n) - out_codes;
}

// s-t min-cut labeling by Boykov-Kolmogorov max-flow — the energy
// minimizer of the Delaunay mesher's graph-cut (the reference delegates to
// CGAL's visibility-consistent surface extraction, ref meshing.h:52-117;
// the Labatut-Pons construction puts per-cell terminal capacities and
// face-area-weighted n-links between adjacent tetrahedra). The JAX
// package's copy of this file runs Dinic; on the dense mesher's ~1.2M
// cells that took minutes, where these two search trees (grown from the
// source and the sink, kept across augmentations and repaired by
// adoption) take seconds. Both end at a maximum flow, and the labels are
// the same function of it: the nodes that reach the source through
// residual arcs above EPS, the unique smallest min-cut source side.
//
// Inputs: m undirected n-links (eu[i], ev[i], ecap[i]) with equal capacity
// both ways; per-node net terminal capacity net_cap[i] (>0: arc from the
// source with that capacity, <0: arc to the sink). Writes label[i] = 1 for
// source-side (outside/free-space) nodes. Returns the number of
// source-side nodes, or -1 on allocation failure.
int64_t graph_min_cut(int64_t n, const int64_t* eu, const int64_t* ev,
                      const float* ecap, int64_t m, const float* net_cap,
                      uint8_t* label) {
  const int64_t NONE = -1, TERMINAL = -2, ORPHAN = -3;
  const int64_t INF_D = INT64_MAX;
  // arcs in pairs: the sister of arc e is e ^ 1; first/nxt list each
  // node's outgoing arcs, head is an arc's end, rcap its residual
  std::vector<int64_t> first, nxt, head, parent, ts, dist;
  std::vector<double> rcap, tr;
  std::vector<uint8_t> sink, queued;
  std::deque<int64_t> active, orphans;
  try {
    first.assign(n, -1);
    nxt.reserve(2 * m);
    head.reserve(2 * m);
    rcap.reserve(2 * m);
    parent.assign(n, NONE);
    ts.assign(n, 0);
    dist.assign(n, 0);
    tr.assign(n, 0.0);
    sink.assign(n, 0);
    queued.assign(n, 0);
    for (int64_t i = 0; i < m; ++i) {
      const int64_t u = eu[i], v = ev[i];
      if (u < 0 || u >= n || v < 0 || v >= n) continue;
      head.push_back(v);
      rcap.push_back(ecap[i]);
      nxt.push_back(first[u]);
      first[u] = (int64_t)head.size() - 1;
      head.push_back(u);
      rcap.push_back(ecap[i]);
      nxt.push_back(first[v]);
      first[v] = (int64_t)head.size() - 1;
    }
  } catch (...) {
    return -1;
  }
  auto set_active = [&](int64_t i) {
    if (!queued[i]) {
      queued[i] = 1;
      active.push_back(i);
    }
  };
  auto orphan = [&](int64_t i) {
    parent[i] = ORPHAN;
    orphans.push_front(i);
  };
  // every node with a terminal capacity roots its own tree
  for (int64_t i = 0; i < n; ++i) {
    tr[i] = net_cap[i];
    if (tr[i] != 0.0) {
      sink[i] = tr[i] < 0.0;
      parent[i] = TERMINAL;
      dist[i] = 1;
      set_active(i);
    }
  }
  int64_t TIME = 0, cur = -1;
  for (;;) {
    // the node that found the last path grows on; else the next active one
    int64_t i = cur >= 0 && parent[cur] != NONE ? cur : -1;
    while (i < 0 && !active.empty()) {
      i = active.front();
      active.pop_front();
      queued[i] = 0;
      if (parent[i] == NONE) i = -1;  // freed since it was queued
    }
    if (i < 0) break;
    // growth: a = the arc from the source tree to the sink tree, if met
    int64_t a = -1;
    for (int64_t e = first[i]; e != -1; e = nxt[e]) {
      if (!(sink[i] ? rcap[e ^ 1] > 0.0 : rcap[e] > 0.0)) continue;
      const int64_t j = head[e];
      if (parent[j] == NONE) {
        sink[j] = sink[i];
        parent[j] = e ^ 1;
        ts[j] = ts[i];
        dist[j] = dist[i] + 1;
        set_active(j);
      } else if (sink[j] != sink[i]) {
        a = sink[i] ? e ^ 1 : e;
        break;
      } else if (ts[j] <= ts[i] && dist[j] > dist[i]) {
        // a shorter way to j's terminal
        parent[j] = e ^ 1;
        ts[j] = ts[i];
        dist[j] = dist[i] + 1;
      }
    }
    ++TIME;
    if (a < 0) {
      cur = -1;
      continue;
    }
    cur = i;
    // augmentation: the bottleneck from the source root through a to the
    // sink root, pushed; saturated tree arcs orphan their child
    double f = rcap[a];
    int64_t k = head[a ^ 1];
    for (; parent[k] != TERMINAL; k = head[parent[k]])
      f = std::min(f, rcap[parent[k] ^ 1]);
    f = std::min(f, tr[k]);
    for (k = head[a]; parent[k] != TERMINAL; k = head[parent[k]])
      f = std::min(f, rcap[parent[k]]);
    f = std::min(f, -tr[k]);
    rcap[a ^ 1] += f;
    rcap[a] -= f;
    for (k = head[a ^ 1]; parent[k] != TERMINAL;) {
      const int64_t pa = parent[k], up = head[pa];
      rcap[pa] += f;
      rcap[pa ^ 1] -= f;
      if (rcap[pa ^ 1] == 0.0) orphan(k);
      k = up;
    }
    tr[k] -= f;
    if (tr[k] == 0.0) orphan(k);
    for (k = head[a]; parent[k] != TERMINAL;) {
      const int64_t pa = parent[k], up = head[pa];
      rcap[pa ^ 1] += f;
      rcap[pa] -= f;
      if (rcap[pa] == 0.0) orphan(k);
      k = up;
    }
    tr[k] += f;
    if (tr[k] == 0.0) orphan(k);
    // adoption: each orphan takes the neighbour in its tree that still
    // reaches the terminal by the shortest known way, or is freed
    while (!orphans.empty()) {
      const int64_t o = orphans.front();
      orphans.pop_front();
      const bool s = sink[o];
      int64_t best = NONE, dmin = INF_D;
      for (int64_t e = first[o]; e != -1; e = nxt[e]) {
        if (!(s ? rcap[e] > 0.0 : rcap[e ^ 1] > 0.0)) continue;
        const int64_t j = head[e];
        if (sink[j] != s || parent[j] == NONE) continue;
        int64_t d = 0, jj = j;
        for (;;) {  // j's origin, and its distance
          if (ts[jj] == TIME) {
            d += dist[jj];
            break;
          }
          const int64_t pa = parent[jj];
          ++d;
          if (pa == TERMINAL) {
            ts[jj] = TIME;
            dist[jj] = 1;
            break;
          }
          if (pa == ORPHAN) {
            d = INF_D;
            break;
          }
          jj = head[pa];
        }
        if (d == INF_D) continue;
        if (d < dmin) {
          best = e;
          dmin = d;
        }
        for (jj = j; ts[jj] != TIME; jj = head[parent[jj]]) {
          ts[jj] = TIME;
          dist[jj] = d--;
        }
      }
      if (best != NONE) {
        parent[o] = best;
        ts[o] = TIME;
        dist[o] = dmin + 1;
        continue;
      }
      parent[o] = NONE;
      for (int64_t e = first[o]; e != -1; e = nxt[e]) {
        const int64_t j = head[e];
        if (sink[j] != s || parent[j] == NONE) continue;
        if (s ? rcap[e] > 0.0 : rcap[e ^ 1] > 0.0) set_active(j);
        const int64_t pa = parent[j];
        if (pa != TERMINAL && pa != ORPHAN && head[pa] == o) {
          parent[j] = ORPHAN;
          orphans.push_back(j);
        }
      }
    }
  }
  // min-cut: source side = residual-reachable from S
  const double EPS = 1e-12;
  std::vector<int64_t> q;
  std::fill(queued.begin(), queued.end(), 0);
  try {
    q.reserve(n);
  } catch (...) {
    return -1;
  }
  for (int64_t i = 0; i < n; ++i) {
    if (tr[i] > EPS) {
      queued[i] = 1;
      q.push_back(i);
    }
  }
  for (size_t h = 0; h < q.size(); ++h) {
    for (int64_t e = first[q[h]]; e != -1; e = nxt[e]) {
      if (rcap[e] > EPS && !queued[head[e]]) {
        queued[head[e]] = 1;
        q.push_back(head[e]);
      }
    }
  }
  int64_t n_src = 0;
  for (int64_t i = 0; i < n; ++i) {
    label[i] = queued[i];
    n_src += label[i];
  }
  return n_src;
}

}  // extern "C"

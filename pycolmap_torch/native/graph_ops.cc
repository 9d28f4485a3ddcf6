// Native correspondence-graph traversal kernels (host C++).
//
// Copy of pycolmap_tpu/native/graph_ops.cc for the PyTorch port: the
// counterpart of the reference's C++ scene/correspondence_graph.cc hot
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

// s-t min-cut labeling by Dinic max-flow — the energy minimizer of the
// Delaunay mesher's graph-cut (the reference delegates to CGAL's
// visibility-consistent surface extraction, ref meshing.h:52-117; the
// Labatut-Pons construction puts per-cell terminal capacities and
// face-area-weighted n-links between adjacent tetrahedra).
//
// Inputs: m undirected n-links (eu[i], ev[i], ecap[i]) with equal capacity
// both ways; per-node net terminal capacity net_cap[i] (>0: arc from the
// source with that capacity, <0: arc to the sink). Writes label[i] = 1 for
// source-side (outside/free-space) nodes. Returns the number of
// source-side nodes, or -1 on allocation failure.
int64_t graph_min_cut(int64_t n, const int64_t* eu, const int64_t* ev,
                      const float* ecap, int64_t m, const float* net_cap,
                      uint8_t* label) {
  const int64_t S = n, T = n + 1, N = n + 2;
  std::vector<int64_t> head, to, nxt;
  std::vector<double> cap;
  try {
    head.assign(N, -1);
    to.reserve(2 * m + 2 * n);
    nxt.reserve(2 * m + 2 * n);
    cap.reserve(2 * m + 2 * n);
  } catch (...) {
    return -1;
  }
  auto add_arc = [&](int64_t u, int64_t v, double c, double crev) {
    to.push_back(v);
    cap.push_back(c);
    nxt.push_back(head[u]);
    head[u] = (int64_t)to.size() - 1;
    to.push_back(u);
    cap.push_back(crev);
    nxt.push_back(head[v]);
    head[v] = (int64_t)to.size() - 1;
  };
  for (int64_t i = 0; i < m; ++i) {
    if (eu[i] < 0 || eu[i] >= n || ev[i] < 0 || ev[i] >= n) continue;
    add_arc(eu[i], ev[i], ecap[i], ecap[i]);
  }
  for (int64_t i = 0; i < n; ++i) {
    if (net_cap[i] > 0.0f) add_arc(S, i, net_cap[i], 0.0);
    else if (net_cap[i] < 0.0f) add_arc(i, T, -(double)net_cap[i], 0.0);
  }
  std::vector<int32_t> level(N);
  std::vector<int64_t> it(N), q(N), path;
  const double EPS = 1e-12;
  auto bfs = [&]() -> bool {
    std::fill(level.begin(), level.end(), -1);
    int64_t qh = 0, qt = 0;
    q[qt++] = S;
    level[S] = 0;
    while (qh < qt) {
      int64_t u = q[qh++];
      for (int64_t e = head[u]; e != -1; e = nxt[e]) {
        if (cap[e] > EPS && level[to[e]] < 0) {
          level[to[e]] = level[u] + 1;
          q[qt++] = to[e];
        }
      }
    }
    return level[T] >= 0;
  };
  while (bfs()) {
    for (int64_t i = 0; i < N; ++i) it[i] = head[i];
    for (;;) {
      // one augmenting path via current-arc iterative DFS
      path.clear();
      int64_t u = S;
      bool found = false;
      for (;;) {
        if (u == T) {
          found = true;
          break;
        }
        int64_t e = it[u];
        while (e != -1 && !(cap[e] > EPS && level[to[e]] == level[u] + 1)) {
          e = nxt[e];
        }
        it[u] = e;
        if (e == -1) {
          if (path.empty()) break;  // no more paths this phase
          level[u] = -1;            // dead end: prune from the level graph
          int64_t pe = path.back();
          path.pop_back();
          u = to[pe ^ 1];  // arc pairs: reverse of e is e^1, tail = to[e^1]
        } else {
          path.push_back(e);
          u = to[e];
        }
      }
      if (!found) break;
      double f = 1e300;
      for (int64_t pe : path) f = std::min(f, cap[pe]);
      for (int64_t pe : path) {
        cap[pe] -= f;
        cap[pe ^ 1] += f;
      }
    }
  }
  // min-cut: source side = residual-reachable from S
  std::fill(level.begin(), level.end(), -1);
  int64_t qh = 0, qt = 0;
  q[qt++] = S;
  level[S] = 0;
  while (qh < qt) {
    int64_t u = q[qh++];
    for (int64_t e = head[u]; e != -1; e = nxt[e]) {
      if (cap[e] > EPS && level[to[e]] < 0) {
        level[to[e]] = 0;
        q[qt++] = to[e];
      }
    }
  }
  int64_t n_src = 0;
  for (int64_t i = 0; i < n; ++i) {
    label[i] = level[i] == 0 ? 1 : 0;
    n_src += label[i];
  }
  return n_src;
}

}  // extern "C"

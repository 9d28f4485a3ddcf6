"""Native (C++) graph operations, loaded via ctypes.

Port of ``pycolmap_tpu/native``: ``graph_ops.cc`` (breadth-first traversals
of the correspondence graph, the triangulator's completion and merge
candidate expansions, and an s-t min-cut by Boykov-Kolmogorov max-flow,
where the reference runs Dinic: the same labels, minutes faster on the
dense mesher's graphs) builds with the host's C++
compiler at first use into ``build/pycolmap_torch/graph_ops-<hash>/``
beside the package (the hash covers the source and the flags), never beside
the source. No Python.h or pybind11: raw pointers from numpy.

Every caller keeps a plain path for a host without a toolchain:
``get_lib()`` returns None there (``build_error`` says why), the
correspondence graph and the triangulator take their numpy paths, and
:func:`min_cut` its pure-Python Dinic.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from collections import deque
from pathlib import Path

import numpy as np

from pycolmap_torch._cuda_build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parent / "graph_ops.cc"
FLAGS = ("-O3", "-shared", "-fPIC")
COMPILERS = ("c++", "g++", "cc")
_lib = None
_tried = False
build_error = None  # why the library is unavailable, None if it loaded


def lib_path() -> Path:
    """build/pycolmap_torch/graph_ops-<hash>/libgraph_ops.so: the hash of
    the source and the flags."""
    h = hashlib.blake2b(digest_size=12)
    h.update(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_ROOT / f"graph_ops-{h.hexdigest()}" / "libgraph_ops.so"


def _build(path: Path) -> None:
    """Compile the source to `path` (through a per-process temporary, so
    concurrent builders never load a half-written library)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    errors = []
    for cc in COMPILERS:
        try:
            res = subprocess.run([cc, *FLAGS, str(SOURCE), "-o", str(tmp)],
                                 capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
            continue
        if res.returncode == 0:
            os.replace(tmp, path)
            return
        errors.append(f"{cc}: {res.stderr.strip()}")
    tmp.unlink(missing_ok=True)
    raise RuntimeError("graph_ops.cc did not build: " + "; ".join(errors))


def _declare(lib) -> None:
    i64, i32, p = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    sigs = {
        "bfs_transitive": [p, p, i64, i64, i32, p, i64, p],
        "bfs_component": [p, p, i64, p, i64, i32, p, p, p, i64, p],
        "expand_complete_candidates": [p, p, p, p, p, p, i64, p, p, i64, p],
        "expand_merge_pairs": [p, p, p, p, i64, p, i64],
        "graph_min_cut": [i64, p, p, p, i64, p, p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = argtypes


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
    except (OSError, RuntimeError, AttributeError) as e:
        # no toolchain, or a library that does not load: the callers'
        # plain paths run
        build_error = f"{type(e).__name__}: {e}"
        _lib = None
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def min_cut(num_nodes: int, edge_u: np.ndarray, edge_v: np.ndarray,
            edge_cap: np.ndarray, net_cap: np.ndarray) -> np.ndarray:
    """s-t min-cut labels over an undirected graph with folded terminal
    capacities (net_cap > 0: source arc, < 0: sink arc). Returns uint8
    labels, 1 = source side: the nodes that reach the source through
    residual arcs, the same for every maximum flow. Native
    Boykov-Kolmogorov when available, else the pure-Python Dinic
    :func:`_min_cut_py`."""
    edge_u = np.ascontiguousarray(edge_u, dtype=np.int64)
    edge_v = np.ascontiguousarray(edge_v, dtype=np.int64)
    edge_cap = np.ascontiguousarray(edge_cap, dtype=np.float32)
    net_cap = np.ascontiguousarray(net_cap, dtype=np.float32)
    lib = get_lib()
    if lib is not None:
        label = np.zeros(max(num_nodes, 1), dtype=np.uint8)
        n = lib.graph_min_cut(
            num_nodes, _ptr(edge_u), _ptr(edge_v), _ptr(edge_cap),
            len(edge_u), _ptr(net_cap), _ptr(label),
        )
        if n >= 0:
            return label[:num_nodes]
    return _min_cut_py(num_nodes, edge_u, edge_v, edge_cap, net_cap)


def _min_cut_py(n, eu, ev, ecap, net):
    """Pure-Python Dinic, the JAX package's ``graph_min_cut`` line for line:
    arcs in pairs (the reverse of arc e is e ^ 1) on linked adjacency
    lists, and each augmenting path found by an iterative current-arc DFS
    (a path may be as long as the graph, far past Python's recursion
    limit)."""
    S, T, N = n, n + 1, n + 2
    head = [-1] * N
    to, cap, nxt = [], [], []

    def add_arc(u, v, c, crev):
        to.append(v)
        cap.append(c)
        nxt.append(head[u])
        head[u] = len(to) - 1
        to.append(u)
        cap.append(crev)
        nxt.append(head[v])
        head[v] = len(to) - 1

    for u, v, c in zip(eu.tolist(), ev.tolist(), ecap.tolist()):
        if 0 <= u < n and 0 <= v < n:
            add_arc(u, v, c, c)
    for i, c in enumerate(net.tolist()):
        if c > 0.0:
            add_arc(S, i, c, 0.0)
        elif c < 0.0:
            add_arc(i, T, -c, 0.0)

    EPS = 1e-12
    level = [-1] * N

    def bfs():
        for i in range(N):
            level[i] = -1
        level[S] = 0
        dq = deque([S])
        while dq:
            u = dq.popleft()
            e = head[u]
            while e != -1:
                if cap[e] > EPS and level[to[e]] < 0:
                    level[to[e]] = level[u] + 1
                    dq.append(to[e])
                e = nxt[e]
        return level[T] >= 0

    while bfs():
        it = list(head)
        while True:
            # one augmenting path via the current-arc iterative DFS
            path = []
            u = S
            while u != T:
                e = it[u]
                while e != -1 and not (cap[e] > EPS
                                       and level[to[e]] == level[u] + 1):
                    e = nxt[e]
                it[u] = e
                if e == -1:
                    if not path:
                        break  # no more paths this phase
                    level[u] = -1  # dead end: prune from the level graph
                    u = to[path.pop() ^ 1]
                else:
                    path.append(e)
                    u = to[e]
            if u != T:
                break
            f = min(cap[e] for e in path)
            for e in path:
                cap[e] -= f
                cap[e ^ 1] += f
    # min cut: the source side is what the residual graph reaches from S
    seen = np.zeros(N, dtype=bool)
    seen[S] = True
    dq = deque([S])
    while dq:
        u = dq.popleft()
        e = head[u]
        while e != -1:
            if cap[e] > EPS and not seen[to[e]]:
                seen[to[e]] = True
                dq.append(to[e])
            e = nxt[e]
    label = np.zeros(max(n, 1), dtype=np.uint8)
    label[:n] = seen[:n]
    return label[:n]


class GraphTraversal:
    """ctypes wrapper holding the per-graph scratch buffer (needs the
    library: callers construct it only when :func:`get_lib` loaded)."""

    def __init__(self, indptr: np.ndarray, adj: np.ndarray):
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self.adj = np.ascontiguousarray(adj, dtype=np.int64)
        self.num_nodes = len(self.indptr) - 1
        self._visited = np.zeros(max(self.num_nodes, 1), dtype=np.uint8)
        self._lib = get_lib()

    @property
    def native(self) -> bool:
        return self._lib is not None

    def bfs_transitive(self, start: int, transitivity: int) -> np.ndarray:
        """Nodes within `transitivity` hops of `start`, in BFS order."""
        out = np.empty(max(self.num_nodes, 1), dtype=np.int64)
        n = self._lib.bfs_transitive(
            _ptr(self.indptr), _ptr(self.adj), self.num_nodes, start,
            transitivity, _ptr(out), len(out), _ptr(self._visited),
        )
        return out[: min(n, len(out))]

    def bfs_component(self, seeds: np.ndarray, max_depth: int,
                      eligible: np.ndarray):
        """(nodes, hop depths) reached from the seeds within `max_depth`
        hops, expanding only through eligible nodes."""
        seeds = np.ascontiguousarray(seeds, dtype=np.int64)
        eligible = np.ascontiguousarray(eligible, dtype=np.uint8)
        out = np.empty(max(self.num_nodes, 1), dtype=np.int64)
        depth = np.empty(max(self.num_nodes, 1), dtype=np.int32)
        n = self._lib.bfs_component(
            _ptr(self.indptr), _ptr(self.adj), self.num_nodes, _ptr(seeds),
            len(seeds), max_depth, _ptr(eligible), _ptr(out), _ptr(depth),
            len(out), _ptr(self._visited),
        )
        n = min(n, len(out))
        return out[:n], depth[:n]

    def expand_complete_candidates(self, node_image, flat_pid, reg_flag,
                                   src_nodes):
        """(target nodes, source pids) for unlinked registered targets of
        the source nodes' edges, deduped by target (first pid wins)."""
        node_image = np.ascontiguousarray(node_image, dtype=np.int32)
        flat_pid = np.ascontiguousarray(flat_pid, dtype=np.int64)
        reg_flag = np.ascontiguousarray(reg_flag, dtype=np.uint8)
        src_nodes = np.ascontiguousarray(src_nodes, dtype=np.int64)
        cap = max(self.num_nodes, 1)
        out_tgt = np.empty(cap, dtype=np.int64)
        out_pid = np.empty(cap, dtype=np.int64)
        n = self._lib.expand_complete_candidates(
            _ptr(self.indptr), _ptr(self.adj), _ptr(node_image),
            _ptr(flat_pid), _ptr(reg_flag), _ptr(src_nodes), len(src_nodes),
            _ptr(out_tgt), _ptr(out_pid), cap, _ptr(self._visited),
        )
        n = min(n, cap)
        return out_tgt[:n], out_pid[:n]

    def expand_merge_pairs(self, flat_pid, src_nodes):
        """Unique packed (min_pid << 32 | max_pid) codes of linked-linked
        edges with distinct pids among the source nodes' edges."""
        flat_pid = np.ascontiguousarray(flat_pid, dtype=np.int64)
        src_nodes = np.ascontiguousarray(src_nodes, dtype=np.int64)
        degs = self.indptr[src_nodes + 1] - self.indptr[src_nodes]
        cap = int(degs.sum()) + 1  # exact bound: one code per edge
        out = np.empty(cap, dtype=np.int64)
        n = self._lib.expand_merge_pairs(
            _ptr(self.indptr), _ptr(self.adj), _ptr(flat_pid),
            _ptr(src_nodes), len(src_nodes), _ptr(out), cap,
        )
        return out[: min(n, cap)]

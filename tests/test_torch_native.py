"""The port's native graph operations (pycolmap_torch/native): the library
builds into build/, never beside its source; each of graph_ops.cc's five
functions equals the port's plain path on the same inputs (the correspondence
graph's Python BFS, the triangulator's numpy expansions, the iterative
Python Dinic); the graph's transitive correspondences equal the reference's
Python traversal on the same database; and the port's Python min-cut equals
the reference's recursive one, and finishes a 20,000-node chain that a
recursive DFS at Python's default recursion limit cannot."""

import sys
from collections import deque

import numpy as np
import pytest
import torch

from pycolmap_tpu.native import _min_cut_py as j_min_cut_py
from pycolmap_tpu.sfm.database_cache import DatabaseCache as JCache
from pycolmap_torch import native
from pycolmap_torch.sfm.database_cache import DatabaseCache
from pycolmap_torch.sfm.incremental_triangulator import (
    complete_candidates_numpy,
    merge_pairs_numpy,
)

from test_incremental_mapping import make_synthetic_database


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    path = tmp_path_factory.mktemp("native") / "db.db"
    make_synthetic_database(path, num_images=6, num_points=200)
    return path


@pytest.fixture(scope="module")
def graph(db):
    return DatabaseCache.load(db).correspondence_graph


def _lib():
    lib = native.get_lib()
    assert lib is not None, native.build_error
    return lib


def test_library_builds_under_build_not_beside_the_source():
    _lib()
    path = native.lib_path()
    assert path.exists()
    assert path.parent.parent == native.BUILD_ROOT
    assert path.parent.name.startswith("graph_ops-")
    assert not list(native.SOURCE.parent.glob("*.so"))


def _python_paths(graph):
    """The graph with its native traversal switched off."""
    graph._traversal = False
    return graph


def test_bfs_transitive_matches_python(db):
    _lib()
    g_native = DatabaseCache.load(db).correspondence_graph
    g_plain = _python_paths(DatabaseCache.load(db).correspondence_graph)
    assert g_native._get_traversal() is not None
    assert g_plain._get_traversal() is None
    rng = np.random.default_rng(0)
    for iid in sorted(g_native._num_points2D):
        n = g_native._num_points2D[iid]
        for k in rng.choice(n, 8, replace=False):
            for hops in (1, 2, 3):
                a = g_native.find_transitive_correspondences(iid, k, hops)
                b = g_plain.find_transitive_correspondences(iid, k, hops)
                assert ([(c.image_id, c.point2D_idx) for c in a]
                        == [(c.image_id, c.point2D_idx) for c in b])


def test_transitive_correspondences_match_the_reference(db, graph):
    """The port's native traversal against the reference's Python loop on
    the same database (the reference's own library is not loaded)."""
    _lib()
    jgraph = _python_paths(JCache.load(db).correspondence_graph)
    assert graph._get_traversal() is not None
    for iid in sorted(graph._num_points2D):
        for k in range(0, graph._num_points2D[iid], 7):
            a = graph.find_transitive_correspondences(iid, k, 2)
            b = jgraph.find_transitive_correspondences(iid, k, 2)
            assert ([(c.image_id, c.point2D_idx) for c in a]
                    == [(c.image_id, c.point2D_idx) for c in b])


def _bfs_component_plain(indptr, adj, seeds, max_depth, eligible):
    """graph_ops.cc bfs_component in Python: level-synchronous BFS from the
    seeds, expanding through eligible nodes only."""
    seen = set()
    frontier = []
    for s in seeds.tolist():
        if 0 <= s < len(indptr) - 1 and s not in seen:
            seen.add(s)
            frontier.append(s)
    out, depth = [], []
    for hop in range(1, max_depth + 1):
        if not frontier:
            break
        nxt = []
        for u in frontier:
            for v in adj[indptr[u]:indptr[u + 1]].tolist():
                if v in seen:
                    continue
                seen.add(v)
                if eligible[v]:
                    out.append(v)
                    depth.append(hop)
                    nxt.append(v)
        frontier = nxt
    return out, depth


def test_bfs_component_matches_plain(graph):
    _lib()
    trav = graph._get_traversal()
    indptr, adj = graph._indptr, graph._adj
    rng = np.random.default_rng(1)
    n = len(indptr) - 1
    for _ in range(10):
        seeds = rng.choice(n, 4, replace=False)
        eligible = (rng.uniform(size=n) > 0.3).astype(np.uint8)
        for depth in (1, 2, 4):
            nodes, hops = trav.bfs_component(seeds, depth, eligible)
            want_nodes, want_hops = _bfs_component_plain(indptr, adj, seeds,
                                                         depth, eligible)
            assert nodes.tolist() == want_nodes
            assert hops.tolist() == want_hops
    # the scratch buffer is clean after each call
    assert not trav._visited.any()


def _link_state(graph, seed):
    """Random point links (-1 = none) and registered images over the
    graph's nodes, as a LinkIndex would hold them."""
    rng = np.random.default_rng(seed)
    _, _, node_image, _, _ = graph.csr_arrays()
    n = len(node_image)
    flat_pid = np.where(rng.uniform(size=n) < 0.4,
                        rng.integers(0, 150, n), -1).astype(np.int64)
    reg = np.zeros(int(node_image.max()) + 1, dtype=bool)
    reg[rng.choice(len(reg), len(reg) // 2 + 1, replace=False)] = True
    src = np.nonzero(flat_pid >= 0)[0]
    src = src[rng.uniform(size=len(src)) < 0.5]
    return node_image, flat_pid, reg, src


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_complete_candidates_matches_numpy(graph, seed):
    _lib()
    trav = graph._get_traversal()
    node_image, flat_pid, reg, src = _link_state(graph, seed)
    tgt, pid = trav.expand_complete_candidates(node_image, flat_pid, reg, src)
    want_tgt, want_pid = complete_candidates_numpy(
        graph._indptr, graph._adj, node_image, flat_pid, reg, src)
    assert len(want_tgt) > 0
    # the same (target, first pid) pairs; the native order is edge order,
    # numpy's is by target
    order = np.argsort(tgt)
    np.testing.assert_array_equal(tgt[order], want_tgt)
    np.testing.assert_array_equal(pid[order], want_pid)
    assert not trav._visited.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_merge_pairs_matches_numpy(graph, seed):
    _lib()
    trav = graph._get_traversal()
    _, flat_pid, _, src = _link_state(graph, seed)
    codes = trav.expand_merge_pairs(flat_pid, src)
    want = merge_pairs_numpy(graph._indptr, graph._adj, flat_pid, src)
    assert len(want) > 0
    np.testing.assert_array_equal(codes, want)


def _random_cut_graph(seed, n=300):
    rng = np.random.default_rng(seed)
    m = 500 if seed % 2 else 1200
    eu = rng.integers(0, n, m)
    ev = rng.integers(0, n, m)
    keep = eu != ev
    eu, ev = eu[keep], ev[keep]
    if seed % 2:  # integer capacities: max flows tie
        cap = rng.integers(1, 4, len(eu)).astype(np.float32)
        net = rng.integers(-9, 10, n).astype(np.float32)
    else:
        cap = rng.uniform(0.1, 3.0, len(eu)).astype(np.float32)
        net = np.where(rng.uniform(size=n) < 0.5,
                       rng.uniform(-4.0, 4.0, n), 0.0).astype(np.float32)
    return n, eu.astype(np.int64), ev.astype(np.int64), cap, net


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_min_cut_matches_reference(seed):
    """The native Boykov-Kolmogorov cut, the port's iterative Python Dinic
    and the reference's recursive one give the same labels."""
    _lib()
    n, eu, ev, cap, net = _random_cut_graph(seed)
    want = j_min_cut_py(n, eu, ev, cap, net)
    got_py = native._min_cut_py(n, eu, ev, cap, net)
    got = native.min_cut(n, eu, ev, cap, net)
    assert 0 < int(want.sum()) < n
    np.testing.assert_array_equal(got_py, want)
    np.testing.assert_array_equal(got, want)


def _chain(n, weak):
    """A path 0 - 1 - ... - n-1, source at 0, sink at n-1; every link of
    capacity 2 but link (weak, weak + 1) of capacity 1: the cut's source
    side is nodes 0..weak."""
    eu = np.arange(n - 1, dtype=np.int64)
    ev = eu + 1
    cap = np.full(n - 1, 2.0, np.float32)
    cap[weak] = 1.0
    net = np.zeros(n, np.float32)
    net[0], net[-1] = 5.0, -5.0
    return eu, ev, cap, net


def test_min_cut_finishes_a_long_chain():
    """Its one augmenting path has 20,001 arcs: the iterative DFS needs no
    recursion (the limit stays Python's default)."""
    n, weak = 20_000, 12_345
    eu, ev, cap, net = _chain(n, weak)
    assert sys.getrecursionlimit() < n
    label = native._min_cut_py(n, eu, ev, cap, net)
    want = np.zeros(n, np.uint8)
    want[:weak + 1] = 1
    np.testing.assert_array_equal(label, want)
    _lib()
    np.testing.assert_array_equal(native.min_cut(n, eu, ev, cap, net), want)


def test_min_cut_edge_cases():
    """No edges, out-of-range edges (skipped, as graph_ops.cc skips them),
    and a graph with no terminal arcs."""
    none = native._min_cut_py(3, np.zeros(0, np.int64), np.zeros(0, np.int64),
                              np.zeros(0, np.float32),
                              np.array([1.0, 0.0, -1.0], np.float32))
    np.testing.assert_array_equal(none, [1, 0, 0])
    eu, ev = np.array([0, 5], np.int64), np.array([1, 1], np.int64)
    cap = np.array([3.0, 9.0], np.float32)
    net = np.array([2.0, -1.0], np.float32)
    _lib()
    for fn in (native._min_cut_py, native.min_cut):
        np.testing.assert_array_equal(fn(2, eu, ev, cap, net), [1, 1])
        np.testing.assert_array_equal(
            fn(2, eu[:1], ev[:1], cap[:1], np.zeros(2, np.float32)), [0, 0])


def test_traversal_queue_is_breadth_first():
    """bfs_transitive returns hop 1 before hop 2 (BFS order), on a small
    hand-made graph: 0 - 1 - 2 - 3 and 0 - 4."""
    _lib()
    adj_list = {0: [1, 4], 1: [0, 2], 2: [1, 3], 3: [2], 4: [0]}
    indptr = np.cumsum([0] + [len(adj_list[i]) for i in range(5)])
    adj = np.concatenate([adj_list[i] for i in range(5)])
    trav = native.GraphTraversal(indptr, adj)
    assert trav.native
    assert trav.bfs_transitive(0, 1).tolist() == [1, 4]
    assert trav.bfs_transitive(0, 2).tolist() == [1, 4, 2]
    assert trav.bfs_transitive(0, 5).tolist() == [1, 4, 2, 3]
    seen, order = {0}, []
    dq = deque([0])
    while dq:
        u = dq.popleft()
        for v in adj_list[u]:
            if v not in seen:
                seen.add(v)
                order.append(v)
                dq.append(v)
    assert trav.bfs_transitive(0, 10).tolist() == order

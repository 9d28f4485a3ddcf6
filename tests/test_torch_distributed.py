"""The port's multi-process layer on the CPU: the partition functions
against the reference's, the sharded extract / match / merge protocol
against one process's database (the twin of
tests/test_distributed.py:106-142, three 128x96 renderings), and one
real two-process run over gloo: each rank holds one CPU shard of the same
bundle, then two (tests/torch_ba_worker.py); the ranks agree, and rank 0
equals the single-process CPU mesh of as many shards."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pycolmap_tpu.parallel import distributed as jd
from pycolmap_torch.parallel import distributed as td
from pycolmap_torch.parallel.device_ctx import ShardMesh
from pycolmap_torch.pipeline import extract_features, match_exhaustive
from pycolmap_torch.pipeline.images import import_images
from pycolmap_torch.scene import Database

from test_full_pipeline import render_scene

HERE = Path(__file__).resolve().parent


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs test files in
    parallel workers, whose thread pools would otherwise contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,k", [(1, 0), (4, 0), (4, 3), (3, 1), (5, 4)])
def test_partitions_match_reference(n, k):
    items = list(range(17))
    pairs = [(i, j) for i in range(6) for j in range(i + 1, 6)]
    assert td.partition_round_robin(items, n, k) == \
        jd.partition_round_robin(items, n, k)
    assert td.partition_pairs(pairs, n, k) == jd.partition_pairs(pairs, n, k)
    assert td.shard_database_path("/a/b.db", k) == \
        jd.shard_database_path("/a/b.db", k)


def test_round_robin_covers_all():
    items = list(range(17))
    shards = [td.partition_round_robin(items, 4, k) for k in range(4)]
    assert sorted(x for s in shards for x in s) == items
    assert max(map(len, shards)) - min(map(len, shards)) <= 1


def test_init_distributed_one_process_and_no_card():
    assert td.init_distributed(num_processes=1) == (0, 1)
    td.barrier()  # no group: a no-op
    with pytest.raises(RuntimeError):  # NCCL needs the card
        td.init_distributed("127.0.0.1:1", num_processes=2, process_id=0)


def test_sharded_pipeline_matches_single_process(tmp_path):
    imgs = tmp_path / "images"
    render_scene(imgs, num_images=3, W=128, H=96)

    db_ref = tmp_path / "ref.db"
    extract_features(db_ref, imgs, device="cpu")
    match_exhaustive(db_ref, device="cpu")

    # 2-way sharded extraction + matching, the shards run in turn
    db = tmp_path / "sharded.db"
    import_images(db, imgs, device="cpu")
    for k in range(2):
        td.extract_features_sharded(db, imgs, process_id=k, num_processes=2,
                                    device="cpu")
    td.merge_feature_shards(db, [td.shard_database_path(db, k)
                                 for k in range(2)])
    for k in range(2):
        td.match_exhaustive_sharded(db, process_id=k, num_processes=2,
                                    device="cpu")
    td.merge_match_shards(db, [td.shard_database_path(db, k)
                               for k in range(2)])

    a, b = Database(db_ref), Database(db)
    try:
        assert a.num_keypoints == b.num_keypoints > 0
        assert a.num_descriptors == b.num_descriptors
        assert a.num_matches == b.num_matches > 0
        assert a.num_verified_image_pairs == b.num_verified_image_pairs > 0
        for img in a.read_all_images():
            iid = b.image_id_from_name(img.name)
            np.testing.assert_array_equal(a.read_keypoints(img.image_id),
                                          b.read_keypoints(iid))
            np.testing.assert_array_equal(a.read_descriptors(img.image_id),
                                          b.read_descriptors(iid))
    finally:
        a.close()
        b.close()


def test_two_process_gloo_bundle_adjustment(tmp_path):
    """Two ranks over gloo, one CPU shard each and then two: the ranks
    agree (tests/test_distributed.py:189-192's tolerances), and rank 0
    equals the single-process mesh of as many shards. Its cross-shard sums
    are the same float sums: two terms, or at four shards three terms and
    an exact zero (the fourth shard of 1,536 points holds none)."""
    sys.path.insert(0, str(HERE))
    import torch_ba_worker

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(PATH=os.environ.get("PATH", ""),
               HOME=os.environ.get("HOME", str(tmp_path)),
               PYTHONPATH=str(HERE.parent), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / "torch_ba_worker.py"), str(tmp_path),
             str(k), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for k in range(2)
    ]
    try:
        # the single-process solves while the ranks start up
        single = {n: torch_ba_worker.solve(ShardMesh(["cpu"] * n))
                  for n in (2, 4)}
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    for n, (problem, s) in single.items():
        r0, r1 = (np.load(tmp_path / f"ba{n}_rank{k}.npz") for k in range(2))
        assert r0["summary"][2] == r1["summary"][2]
        assert r0["summary"][1] == pytest.approx(r1["summary"][1], rel=1e-5)
        np.testing.assert_allclose(r0["cam_quat"][1], r1["cam_quat"][1],
                                   atol=1e-5)
        np.testing.assert_allclose(r0["points"][7], r1["points"][7],
                                   atol=1e-5)

        assert r0["summary"][2] == s.num_iterations
        assert r0["summary"][:2] == pytest.approx(
            [s.initial_cost, s.final_cost], rel=1e-6)
        for f in ("cam_quat", "cam_trans", "points"):
            want = getattr(problem, f).numpy()
            np.testing.assert_allclose(r0[f], want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{n} shards: {f}")

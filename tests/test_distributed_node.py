"""Distributed online node: per-host ingest + global-mesh estimation.

The reference's core scenario is N robots feeding ONE live merge node
(src/map_merge_node.cpp:57-100). The multi-host analog (SURVEY §2c,
VERDICT r2 item 6) runs one MapMergeNode per host: each host's transport
ingests only its own robots' maps, an estimation tick exchanges them over
the network (parallel/multihost.allgather_robot_maps) so every process runs the
same SPMD program over the global mesh, and the graph solve replicates on
every host. This test spawns 2 OS processes joined in one jax.distributed
job, each feeding a DIFFERENT robot through its own DirectoryTransport,
and asserts both hosts converge on the same global poses + merged map.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.slow  # spawns processes, compiles the pipeline

_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    import jax

    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_platforms", "cpu")

    from mapmerge_tpu.parallel import multihost

    pid = int(sys.argv[1])
    watch_dir = sys.argv[2]
    multihost.initialize(
        coordinator_address={coord!r}, num_processes=2, process_id=pid,
    )
    assert jax.process_count() == 2

    import numpy as np
    from synthetic import make_scene, overlapping_views, rotation_z, se3
    from mapmerge_tpu.core import transforms as tf
    from mapmerge_tpu.core.params import MergeParams
    from mapmerge_tpu.io.pcd import write_pcd
    from mapmerge_tpu.runtime.node import MapMergeNode
    from mapmerge_tpu.runtime.transport import DirectoryTransport

    rng = np.random.default_rng(7)
    xyz, rgb = make_scene(rng, n_boxes=6, extent=8.0, density=40.0)
    truth = se3(rotation_z(0.35), [1.2, -0.5, 0.15])
    va, vb = overlapping_views(
        np.random.default_rng(3), xyz, rgb, truth, overlap=0.65
    )
    # host 0 ingests robot_a's map only, host 1 robot_b's only
    view = va if pid == 0 else vb
    name = "robot_a" if pid == 0 else "robot_b"
    m = np.asarray(view.mask)
    write_pcd(
        os.path.join(watch_dir, name + ".pcd"),
        (np.asarray(view.xyz)[m], np.asarray(view.rgb)[m]),
    )

    params = MergeParams(
        keypoint_type="HARRIS", keypoint_threshold=5.0,
        descriptor_type="FPFH", refine_transform=False,
        max_points=4096, max_keypoints=128, max_neighbors=32,
        ransac_hypotheses=256, neighbor_tile=256,
    )
    node = MapMergeNode(
        DirectoryTransport(watch_dir), params=params,
        mesh=multihost.global_mesh(), seed=0,
    )
    node.discovery()
    assert node.get_robots() == [name], node.get_robots()

    # lockstep ticks (the distributed deployment contract: estimation and
    # compositing are collectives, driven together on every host)
    node.transforms_estimation()
    poses = node.get_transforms()
    assert set(poses) == {{"robot_a", "robot_b"}}, set(poses)
    assert poses["robot_a"].any() and poses["robot_b"].any()
    rel = np.linalg.inv(poses["robot_a"]) @ poses["robot_b"]
    rot = float(tf.rotation_geodesic_deg(rel.astype(np.float32), truth))
    trans = float(np.linalg.norm(rel[:3, 3] - truth[:3, 3]))
    assert rot < 3.0, f"rot {{rot}}"
    assert trans < 0.2, f"trans {{trans}}"

    node.map_compositing()
    merged = node.get_merged_map()
    assert merged is not None
    n_merged = int(np.asarray(merged.mask).sum())
    assert n_merged > 1000, n_merged
    print(
        f"proc {{pid}} OK rot={{rot:.3f}} trans={{trans:.4f}} "
        f"merged={{n_merged}}",
        flush=True,
    )
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestDistributedNode:
    def test_two_hosts_two_robots_one_global_map(self, tmp_path):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        coord = f"localhost:{_free_port()}"
        script = _WORKER.format(
            repo=repo, tests=os.path.join(repo, "tests"), coord=coord
        )
        path = tmp_path / "worker.py"
        path.write_text(script)
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env.pop("XLA_FLAGS", None)
        procs = []
        for i in range(2):
            d = tmp_path / f"maps_{i}"
            d.mkdir()
            procs.append(
                subprocess.Popen(
                    [sys.executable, str(path), str(i), str(d)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    env=env,
                )
            )
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=420)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append(out.decode())
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
            assert "OK rot=" in out

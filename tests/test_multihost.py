"""Real multi-process jax.distributed test (VERDICT r1 item 7).

Spawns 2 OS processes that join one jax.distributed job over localhost
(the cross-host path, on CPU), build the global mesh via
parallel.multihost, and run the mesh-sharded 5-map merge — exercising
exactly the code path SURVEY.md §2c promises for multi-host: per-host
CPU devices federated into one mesh, feature batch + pair axis sharded
across processes, graph solve replicated on every host.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # spawns processes, compiles the pipeline

_WORKER = textwrap.dedent(
    """
    import os, sys
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    import jax

    # each process contributes 2 virtual CPU devices to the job
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_platforms", "cpu")

    from mapmerge_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address={coord!r},
        num_processes=2,
        process_id=int(sys.argv[1]),
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()  # 2 hosts x 2 devices

    import numpy as np
    from synthetic import make_scene, overlapping_views, rotation_z, se3
    from mapmerge_tpu.core import transforms as tf
    from mapmerge_tpu.core.params import MergeParams
    from mapmerge_tpu.pipeline.merging import estimate_maps_transforms

    mesh = multihost.global_mesh()
    assert mesh.devices.size == 4

    rng = np.random.default_rng(7)
    xyz, rgb = make_scene(rng, n_boxes=6, extent=8.0, density=40.0)
    truth = se3(rotation_z(0.35), [1.2, -0.5, 0.15])
    va, vb = overlapping_views(
        np.random.default_rng(3), xyz, rgb, truth, overlap=0.65
    )
    params = MergeParams(
        keypoint_type="HARRIS", keypoint_threshold=5.0,
        descriptor_type="FPFH", refine_transform=False,
        max_points=4096, max_keypoints=128, max_neighbors=32,
        ransac_hypotheses=256, neighbor_tile=256,
    )
    # every process runs the same program over the global mesh (SPMD);
    # the two extra identical views make 4 clouds = one per device
    transforms = estimate_maps_transforms(
        [va, vb, va, vb], params, seed=0, mesh=mesh
    )
    assert len(transforms) == 4, len(transforms)
    rel = np.linalg.inv(transforms[0]) @ transforms[1]
    rot = float(tf.rotation_geodesic_deg(rel.astype(np.float32), truth))
    trans = float(np.linalg.norm(rel[:3, 3] - truth[:3, 3]))
    assert rot < 3.0, f"rot {{rot}}"
    assert trans < 0.2, f"trans {{trans}}"
    print(f"proc {{jax.process_index()}} OK rot={{rot:.3f}} trans={{trans:.4f}}",
          flush=True)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestTwoProcessDistributed:
    def test_sharded_merge_across_two_processes(self, tmp_path):
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
        procs = [
            subprocess.Popen(
                [sys.executable, str(path), str(i)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            )
            for i in range(2)
        ]
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

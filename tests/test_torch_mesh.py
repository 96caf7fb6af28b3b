"""The process-group path of the row-sharded detector on the CPU: four
processes joined by gloo on loopback (parallel/mesh.py), each holding one
band of a 640x480 frame, must give the trinary, labels and detections of the
one-device band batch. The children are plain scripts run by subprocess,
and the whole run is bounded, so a hung collective fails the test."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from isaac_ros_apriltag_tpu_torch import (CameraModel, DetectorConfig, SpatialDetector,
                                          build_spatial_front_fn, get_family)
from isaac_ros_apriltag_tpu_torch.utils.render import render_tags, upright_pose

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 100

_CHILD = """
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from isaac_ros_apriltag_tpu_torch import SpatialDetector, build_spatial_front_fn, make_mesh
from isaac_ros_apriltag_tpu_torch.parallel import mesh as pmesh
from test_torch_mesh import CFG, camera, scene

torch.set_num_threads(1)

addr, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
pmesh.initialize_multihost(addr, {world}, rank, backend="gloo")
try:
    group = make_mesh({world}, 1).get_group("cam")
    band = torch.full((1, 3, 5), rank, dtype=torch.int32)
    above, below = pmesh.neighbor_rows(band, 2, group)
    gathered = pmesh.all_gather_bands(band, group)
    img = scene()
    tri, lab = build_spatial_front_fn(CFG, camera(), {world}, group=group)(torch.from_numpy(img))
    det = SpatialDetector(CFG, camera(), {world}, device="cpu", group=group).detect(img)
    np.savez(out, tri=tri.numpy(), lab=lab.numpy(), above=above.numpy(), below=below.numpy(),
             gathered=gathered.numpy(),
             **{{f"det_{{k}}": v.numpy() for k, v in vars(det).items()}})
finally:
    dist.destroy_process_group()
"""

CFG = DetectorConfig(tag_size=0.16, backend="torch")


def camera():
    return CameraModel.create(fx=420.0, fy=420.0, cx=320.0, cy=240.0, width=640, height=480)


def scene():
    """Four tags, noise 1, seed 0, rendered by the port."""
    cam, fam = camera(), get_family("tag36h11")
    tags = []
    for i, (x, y) in enumerate([(-0.25, -0.15), (0.25, -0.15), (-0.25, 0.18), (0.25, 0.18)]):
        t = np.array([x, y, 1.1])
        tags.append(dict(family=fam, id=3 * i + 1, R=upright_pose(t, 0.1 * i), t=t,
                         tag_size=0.16))
    return render_tags(cam.K.numpy(), (480, 640), tags, noise=1.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks; their saved outputs, in rank order."""
    tmp = tmp_path_factory.mktemp("mesh")
    script = tmp / "child.py"
    script.write_text(_CHILD.format(root=ROOT, tests=os.path.join(ROOT, "tests"), world=WORLD))
    addr = f"127.0.0.1:{_free_port()}"
    outs = [tmp / f"rank{r}.npz" for r in range(WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), addr, str(r), str(outs[r])],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    except subprocess.TimeoutExpired:
        errors.append(f"the ranks did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errors, "\n".join(errors)
    return [dict(np.load(o)) for o in outs]


def test_exchanges_move_the_right_rows(ranks):
    """neighbor_rows: rank r gets rank r - 1's rows from above and rank r +
    1's from below, zeros past the first and last rank; all_gather_bands:
    every rank's band in rank order."""
    for r, out in enumerate(ranks):
        assert (out["above"] == (r - 1 if r > 0 else 0)).all()
        assert (out["below"] == (r + 1 if r < WORLD - 1 else 0)).all()
        assert out["above"].shape == out["below"].shape == (1, 2, 5)
        np.testing.assert_array_equal(out["gathered"][:, 0, 0], np.arange(WORLD))


def test_ranks_equal_one_device_band_batch(ranks):
    """Every rank's trinary and labels are the one-device band batch's, bit
    for bit, and so are its detections."""
    img = scene()
    tri, lab = build_spatial_front_fn(CFG, camera(), WORLD)(torch.from_numpy(img))
    det = SpatialDetector(CFG, camera(), WORLD, device="cpu").detect(img)
    assert len(det.to_list()) == 4
    for out in ranks:
        np.testing.assert_array_equal(out["tri"], tri.numpy())
        np.testing.assert_array_equal(out["lab"], lab.numpy())
        for k, v in vars(det).items():
            np.testing.assert_array_equal(out[f"det_{k}"], v.numpy(), err_msg=k)


def test_make_mesh_needs_a_process_group():
    from isaac_ros_apriltag_tpu_torch import make_mesh

    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh(2, 2)

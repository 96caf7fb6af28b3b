"""Tag-map SLAM frontend: landmark store, data association, keyframes.

Counterpart of ``isaac_ros_apriltag_tpu/parallel/slam/map.py``: host-side
orchestration (python/numpy) around the device-side optimizers (ba.py,
dba.py). Data association is exact (tag ids are unique), so the first
sighting of an id initializes its landmark from the current camera pose
estimate, and every sighting appends an observation (the 4 corners) for BA.

``process_frame`` copies the frame's valid, id, corners, rotation and
translation to the host in one transfer, one sync a frame, which a host-side
mapper needs. ``save`` and ``load`` use the reference's npz keys and dtypes,
so either package reads a map the other wrote.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...types import Detections
from .ba import BAProblem


@dataclasses.dataclass
class TagMapper:
    """Accumulates keyframes + tag observations; builds BA problems on
    `device` (default: the card; pass device='cpu' for the CPU)."""

    K: np.ndarray                 # (3, 3) intrinsics
    tag_size: float
    max_obs: int = 4096
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.lm_ids: list[int] = []
        self.lm_R: list[np.ndarray] = []
        self.lm_t: list[np.ndarray] = []
        self.kf_R: list[np.ndarray] = []
        self.kf_t: list[np.ndarray] = []
        self.obs: list[tuple[int, int, np.ndarray]] = []  # (kf, lm, corners)

    # ------------------------------------------------------------------
    def process_frame(self, det: Detections) -> int:
        """Ingest one frame's detections; returns the new keyframe index.

        Camera pose is estimated from already-mapped tags (average of the
        per-tag camera poses); the first frame defines the world origin.
        """
        T = det.valid.shape[0]
        host = torch.cat([det.valid[:, None].double(), det.id[:, None].double(),
                          det.corners.reshape(T, 8).double(), det.rotation.reshape(T, 9).double(),
                          det.translation.double()], 1).cpu().numpy()
        valid = host[:, 0] != 0
        ids = host[:, 1].astype(np.int32)
        corners = host[:, 2:10].reshape(T, 4, 2).astype(np.float32)
        R_ct = host[:, 10:19].reshape(T, 3, 3).astype(np.float32)   # R_camera_tag
        t_ct = host[:, 19:22].astype(np.float32)

        idx = np.nonzero(valid)[0]
        known = [i for i in idx if int(ids[i]) in self.lm_ids]

        if not self.kf_R:
            R_wc, t_wc = np.eye(3), np.zeros(3)
        elif known:
            # camera pose votes from each known tag: T_wc = T_wt * T_ct^-1
            Rs, ts = [], []
            for i in known:
                l = self.lm_ids.index(int(ids[i]))
                R_wt, t_wt = self.lm_R[l], self.lm_t[l]
                R = R_wt @ R_ct[i].T
                t = t_wt - R @ t_ct[i]
                Rs.append(R)
                ts.append(t)
            t_wc = np.mean(ts, 0)
            # chordal mean of rotations
            M = np.sum(Rs, 0)
            U, _, Vt = np.linalg.svd(M)
            R_wc = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
        else:
            # no overlap: propagate previous pose (constant position model)
            R_wc, t_wc = self.kf_R[-1], self.kf_t[-1]

        k = len(self.kf_R)
        self.kf_R.append(R_wc)
        self.kf_t.append(t_wc)

        for i in idx:
            tid = int(ids[i])
            if tid not in self.lm_ids:
                self.lm_ids.append(tid)
                self.lm_R.append(R_wc @ R_ct[i])
                self.lm_t.append(t_wc + R_wc @ t_ct[i])
            l = self.lm_ids.index(tid)
            self.obs.append((k, l, corners[i].copy()))
        return k

    # ------------------------------------------------------------------
    def build_problem(self) -> BAProblem:
        O = len(self.obs)
        obs_kf = np.zeros(O, np.int64)
        obs_lm = np.zeros(O, np.int64)
        obs_uv = np.zeros((O, 4, 2), np.float32)
        for o, (k, l, uv) in enumerate(self.obs):
            obs_kf[o], obs_lm[o], obs_uv[o] = k, l, uv
        f32 = np.float32

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return BAProblem(
            cam_R=dev(np.stack(self.kf_R).astype(f32)),
            cam_t=dev(np.stack(self.kf_t).astype(f32)),
            lm_R=dev(np.stack(self.lm_R).astype(f32)),
            lm_t=dev(np.stack(self.lm_t).astype(f32)),
            obs_kf=dev(obs_kf),
            obs_lm=dev(obs_lm),
            obs_uv=dev(obs_uv),
            obs_valid=dev(np.ones(O, bool)),
            K=dev(np.asarray(self.K, f32)),
            tag_size=dev(np.asarray(self.tag_size, f32)),
        )

    def save(self, path: str) -> None:
        """Checkpoint the map (landmarks + keyframes + observations) as npz,
        with the reference's keys and dtypes."""
        O = len(self.obs)
        obs_kf = np.array([o[0] for o in self.obs], np.int32)
        obs_lm = np.array([o[1] for o in self.obs], np.int32)
        obs_uv = (np.stack([o[2] for o in self.obs]).astype(np.float32)
                  if O else np.zeros((0, 4, 2), np.float32))
        np.savez_compressed(
            path,
            lm_ids=np.asarray(self.lm_ids, np.int64),
            lm_R=(np.stack(self.lm_R) if self.lm_ids else np.zeros((0, 3, 3))),
            lm_t=(np.stack(self.lm_t) if self.lm_ids else np.zeros((0, 3))),
            kf_R=(np.stack(self.kf_R) if self.kf_R else np.zeros((0, 3, 3))),
            kf_t=(np.stack(self.kf_t) if self.kf_R else np.zeros((0, 3))),
            obs_kf=obs_kf, obs_lm=obs_lm, obs_uv=obs_uv,
            K=self.K, tag_size=np.float64(self.tag_size))

    def load(self, path: str) -> None:
        """Restore state written by save() (of either package); replaces the
        current contents."""
        with np.load(path) as z:
            self.lm_ids = [int(i) for i in z["lm_ids"]]
            self.lm_R = [r for r in z["lm_R"]]
            self.lm_t = [t for t in z["lm_t"]]
            self.kf_R = [r for r in z["kf_R"]]
            self.kf_t = [t for t in z["kf_t"]]
            self.obs = [(int(k), int(l), uv) for k, l, uv in
                        zip(z["obs_kf"], z["obs_lm"], z["obs_uv"])]
            self.K = z["K"]
            self.tag_size = float(z["tag_size"])

    def update_from_problem(self, p: BAProblem) -> None:
        self.kf_R = list(p.cam_R.cpu().numpy())
        self.kf_t = list(p.cam_t.cpu().numpy())
        self.lm_R = list(p.lm_R.cpu().numpy()[:len(self.lm_ids)])
        self.lm_t = list(p.lm_t.cpu().numpy()[:len(self.lm_ids)])


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray) -> float:
    """Absolute trajectory error after SE(3) (Umeyama, no scale) alignment."""
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, Gm = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(E.T @ Gm)
    S = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R = (U @ S @ Vt).T         # maps est -> gt frame
    resid = (R @ E.T).T + mu_g - gt
    return float(np.sqrt((resid ** 2).sum(-1).mean()))

"""Dataset loaders: TUM, Bonn, EuRoC, ETH3D, 7-Scenes, MP4, RGB dirs, webcam.

The port's own copy of the JAX package's `data/datasets.py`: the same
directory layouts, hardcoded calibrations and undistortion as the reference
`mast3r_slam/dataloader.py:20-368`, as plain-Python iterables. Frames are
host numpy arrays; the upload to the card is `data/prefetch.py`'s. OpenCV
is imported where a frame is read or undistorted, pyrealsense2 only by the
RealSense reader. The calibration switch is the port's own global config
(`app/config.py`).
"""

from __future__ import annotations

import pathlib
import re
from typing import List, Optional

import numpy as np

from monst3r_slam_torch.app.config import config
from monst3r_slam_torch.data.preprocess import resize_img


def natsorted(paths):
    def key(p):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", str(p))]

    return sorted(paths, key=key)


class MonocularDataset:
    """Base: timestamp + RGB iteration (dataloader.py:20-64)."""

    def __init__(self, dtype=np.float32):
        self.dtype = dtype
        self.rgb_files: List[pathlib.Path] = []
        self.timestamps = []
        self.img_size = 512
        self.camera_intrinsics: Optional[Intrinsics] = None
        self.use_calibration = bool(config.get("use_calib", False))
        self.save_results = True

    def __len__(self):
        return len(self.rgb_files)

    def __getitem__(self, idx):
        img = self.get_image(idx)
        return self.get_timestamp(idx), img

    def get_timestamp(self, idx):
        return self.timestamps[idx]

    def read_img(self, idx) -> np.ndarray:
        import cv2

        img = cv2.imread(str(self.rgb_files[idx]))
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def get_image(self, idx) -> np.ndarray:
        img = self.read_img(idx)
        if self.use_calibration and self.camera_intrinsics is not None:
            img = self.camera_intrinsics.remap(img)
        return img.astype(self.dtype) / 255.0

    def get_img_shape(self):
        img = self.read_img(0)
        out = resize_img(img.astype(self.dtype) / 255.0, self.img_size)
        return tuple(out["img"][0].shape[:2]), img.shape[:2]

    def subsample(self, stride: int):
        self.rgb_files = self.rgb_files[::stride]
        self.timestamps = self.timestamps[::stride]

    def has_calib(self):
        return self.camera_intrinsics is not None


def _read_rgb_txt(dataset_path: pathlib.Path):
    tstamp_rgb = np.loadtxt(dataset_path / "rgb.txt", delimiter=" ", dtype=str, comments="#")
    return [dataset_path / f for f in tstamp_rgb[:, 1]], list(tstamp_rgb[:, 0])


class TUMDataset(MonocularDataset):
    """TUM RGB-D (dataloader.py:67-105), freiburg1/2/3 hardcoded calib."""

    CALIB = {
        1: [517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633],
        2: [520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033, -0.0001, 0.9172],
        3: [535.4, 539.2, 320.1, 247.6],
    }

    def __init__(self, dataset_path):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files, self.timestamps = _read_rgb_txt(self.dataset_path)
        match = re.search(r"freiburg(\d+)", str(dataset_path))
        if match:
            self.camera_intrinsics = Intrinsics.from_calib(
                self.img_size, 640, 480, np.asarray(self.CALIB[int(match.group(1))])
            )


class BonnDataset(MonocularDataset):
    """Bonn RGB-D Dynamic (dataloader.py:107-118)."""

    CALIB = [542.822841, 542.576870, 315.593520, 237.756098,
             0.039903, -0.099343, -0.000730, -0.000144, 0.0]

    def __init__(self, dataset_path):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files, self.timestamps = _read_rgb_txt(self.dataset_path)
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, 640, 480, np.asarray(self.CALIB)
        )


class EurocDataset(MonocularDataset):
    """EuRoC MAV (dataloader.py:120-145): always undistorts cam0."""

    def __init__(self, dataset_path):
        super().__init__()
        import yaml

        self.use_calibration = True
        self.dataset_path = pathlib.Path(dataset_path)
        tstamp_rgb = np.loadtxt(
            self.dataset_path / "mav0/cam0/data.csv", delimiter=",", dtype=str, comments="#"
        )
        self.rgb_files = [self.dataset_path / "mav0/cam0/data" / f for f in tstamp_rgb[:, 1]]
        self.timestamps = list(tstamp_rgb[:, 0])
        with open(self.dataset_path / "mav0/cam0/sensor.yaml") as f:
            cam0 = yaml.safe_load(f)
        W, H = cam0["resolution"]
        calib = np.asarray([*cam0["intrinsics"], *cam0["distortion_coefficients"]])
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, W, H, calib, always_undistort=True
        )

    def read_img(self, idx):
        import cv2

        img = cv2.imread(str(self.rgb_files[idx]), cv2.IMREAD_GRAYSCALE)
        return cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)


class ETH3DDataset(MonocularDataset):
    def __init__(self, dataset_path):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files, self.timestamps = _read_rgb_txt(self.dataset_path)
        calib = np.loadtxt(self.dataset_path / "calibration.txt", dtype=np.float32)
        _, (H, W) = self.get_img_shape()
        self.camera_intrinsics = Intrinsics.from_calib(self.img_size, W, H, calib)


class SevenScenesDataset(MonocularDataset):
    def __init__(self, dataset_path):
        super().__init__()
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files = natsorted((self.dataset_path / "seq-01").glob("*.color.png"))
        self.timestamps = list(np.arange(len(self.rgb_files)).astype(self.dtype))
        self.camera_intrinsics = Intrinsics.from_calib(
            self.img_size, 640, 480, np.asarray([585.0, 585.0, 320.0, 240.0])
        )


class MP4Dataset(MonocularDataset):
    def __init__(self, dataset_path):
        super().__init__()
        import cv2

        self.use_calibration = False
        self.dataset_path = pathlib.Path(dataset_path)
        self.cap = cv2.VideoCapture(str(self.dataset_path))
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.total_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.stride = int(config.get("dataset", {}).get("subsample", 1))
        self.timestamps = []

    def __len__(self):
        return self.total_frames // self.stride

    def subsample(self, stride):
        self.stride = max(self.stride, stride)

    def read_img(self, idx):
        import cv2

        self.cap.set(cv2.CAP_PROP_POS_FRAMES, idx * self.stride)
        ret, img = self.cap.read()
        if not ret:
            raise ValueError("Failed to read image")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        while len(self.timestamps) <= idx:
            self.timestamps.append(len(self.timestamps) * self.stride / self.fps)
        return img


class RGBFiles(MonocularDataset):
    def __init__(self, dataset_path):
        super().__init__()
        self.use_calibration = False
        self.dataset_path = pathlib.Path(dataset_path)
        self.rgb_files = natsorted(self.dataset_path.glob("*.png")) or natsorted(
            self.dataset_path.glob("*.jpg")
        )
        self.timestamps = list(np.arange(len(self.rgb_files)).astype(self.dtype) / 30.0)


class RealsenseDataset(MonocularDataset):
    """Live RealSense capture (dataloader.py:179-232); needs pyrealsense2."""

    def __init__(self):
        super().__init__()
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise ImportError(
                "RealsenseDataset requires pyrealsense2; install it or use a recorded dataset"
            ) from e
        self.pipeline = rs.pipeline()
        self.h, self.w = 480, 640
        rs_config = rs.config()
        rs_config.enable_stream(rs.stream.color, self.w, self.h, rs.format.bgr8, 30)
        self.profile = self.pipeline.start(rs_config)
        self.save_results = False
        self.timestamps = []
        if self.use_calibration:
            rgb_profile = rs.video_stream_profile(self.profile.get_stream(rs.stream.color))
            intr = rgb_profile.get_intrinsics()
            self.camera_intrinsics = Intrinsics.from_calib(
                self.img_size, self.w, self.h,
                np.asarray([intr.fx, intr.fy, intr.ppx, intr.ppy]),
            )

    def __len__(self):
        return 999999

    def read_img(self, idx):
        import cv2

        frameset = self.pipeline.wait_for_frames()
        self.timestamps.append(frameset.get_timestamp() / 1000)
        img = np.asanyarray(frameset.get_color_frame().get_data())
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class Webcam(MonocularDataset):
    def __init__(self):
        super().__init__()
        import cv2

        self.use_calibration = False
        self.cap = cv2.VideoCapture(-1)
        self.save_results = False
        self.timestamps = []

    def __len__(self):
        return 999999

    def read_img(self, idx):
        import cv2

        ret, img = self.cap.read()
        if not ret:
            raise ValueError("Failed to read image")
        self.timestamps.append(idx / 30)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class Intrinsics:
    """Undistortion + K rescaled to the 512-res frame (dataloader.py:305-345)."""

    def __init__(self, img_size, W, H, K_orig, K, distortion, mapx, mapy):
        self.img_size = img_size
        self.W, self.H = W, H
        self.K_orig = K_orig
        self.K = K
        self.distortion = distortion
        self.mapx = mapx
        self.mapy = mapy
        _, (scale_w, scale_h, half_crop_w, half_crop_h) = resize_img(
            np.zeros((H, W, 3), np.float32), img_size, return_transformation=True
        )
        self.K_frame = self.K.copy()
        self.K_frame[0, 0] = self.K[0, 0] / scale_w
        self.K_frame[1, 1] = self.K[1, 1] / scale_h
        self.K_frame[0, 2] = self.K[0, 2] / scale_w - half_crop_w
        self.K_frame[1, 2] = self.K[1, 2] / scale_h - half_crop_h

    def remap(self, img):
        import cv2

        return cv2.remap(img, self.mapx, self.mapy, cv2.INTER_LINEAR)

    @staticmethod
    def from_calib(img_size, W, H, calib, always_undistort=False):
        import cv2

        if not config.get("use_calib", False) and not always_undistort:
            return None
        fx, fy, cx, cy = calib[:4]
        distortion = np.asarray(calib[4:]) if len(calib) > 4 else np.zeros(4)
        K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        center = config.get("dataset", {}).get("center_principle_point", True)
        K_opt, _ = cv2.getOptimalNewCameraMatrix(
            K, distortion, (W, H), 0, (W, H), centerPrincipalPoint=center
        )
        mapx, mapy = cv2.initUndistortRectifyMap(K, distortion, None, K_opt, (W, H), cv2.CV_32FC1)
        return Intrinsics(img_size, W, H, K, K_opt, distortion, mapx, mapy)


def load_dataset(dataset_path: str) -> MonocularDataset:
    """Path-based dataset dispatch (dataloader.py:348-368)."""
    parts = dataset_path.split("/")
    if "bonn" in parts:
        return BonnDataset(dataset_path)
    if any("tum" in s.lower() for s in parts):
        return TUMDataset(dataset_path)
    if "euroc" in parts:
        return EurocDataset(dataset_path)
    if "eth3d" in parts:
        return ETH3DDataset(dataset_path)
    if "7-scenes" in parts:
        return SevenScenesDataset(dataset_path)
    if "realsense" in parts:
        return RealsenseDataset()
    if "webcam" in parts:
        return Webcam()
    if parts[-1].split(".")[-1] in ("mp4", "avi", "MOV", "mov"):
        return MP4Dataset(dataset_path)
    return RGBFiles(dataset_path)

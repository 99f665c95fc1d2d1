"""Video frame loading (sam2/utils/misc.py:92-213; the port's copy of the JAX
package's `utils/video.py`).

Frames load from a directory of JPEG/PNG files named by frame index. The
async variant prefetches frames on a daemon thread (the reference's
AsyncVideoFrameLoader) while the first frame returns immediately.
"""

from __future__ import annotations

import os
import threading

import numpy as np
from PIL import Image


def _frame_paths(video_path: str) -> list[str]:
    exts = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")
    names = [f for f in os.listdir(video_path) if f.endswith(exts)]
    try:
        names.sort(key=lambda p: int(os.path.splitext(p)[0]))
    except ValueError:
        names.sort()
    if not names:
        raise RuntimeError(f"no images found in {video_path}")
    return [os.path.join(video_path, f) for f in names]


def load_video_frames(video_path: str) -> tuple[np.ndarray, int, int]:
    """Load all frames as (T, H, W, 3) uint8."""
    paths = _frame_paths(video_path)
    first = np.asarray(Image.open(paths[0]).convert("RGB"))
    h, w = first.shape[:2]
    frames = np.empty((len(paths), h, w, 3), np.uint8)
    frames[0] = first
    for i, p in enumerate(paths[1:], start=1):
        frames[i] = np.asarray(Image.open(p).convert("RGB"))
    return frames, h, w


class AsyncVideoFrameLoader:
    """Thread-prefetched frame access (misc.py:104-160): indexing blocks
    until the frame is decoded; exceptions propagate on next access."""

    def __init__(self, video_path: str):
        self.paths = _frame_paths(video_path)
        first = np.asarray(Image.open(self.paths[0]).convert("RGB"))
        self.video_height, self.video_width = first.shape[:2]
        self.frames: list[np.ndarray | None] = [None] * len(self.paths)
        self.frames[0] = first
        self.exception: BaseException | None = None
        self._done = threading.Event()
        self.thread = threading.Thread(target=self._load_all, daemon=True)
        self.thread.start()

    def _load_all(self):
        try:
            for i, p in enumerate(self.paths):
                if self.frames[i] is None:
                    self.frames[i] = np.asarray(Image.open(p).convert("RGB"))
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            self.exception = e
        finally:
            self._done.set()

    def __getitem__(self, index: int) -> np.ndarray:
        if self.exception is not None:
            raise RuntimeError("frame loading failed") from self.exception
        frame = self.frames[index]
        if frame is None:
            # decode on demand rather than wait for the background sweep
            frame = np.asarray(Image.open(self.paths[index]).convert("RGB"))
            self.frames[index] = frame
        return frame

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def shape(self):
        return (len(self.paths), self.video_height, self.video_width, 3)

"""Host-side video decode/encode: port of hockey_tpu/video/io.py.

OpenCV is imported inside the functions that need it, so the numeric path
of the port imports without it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils.profiling import annotate


@dataclasses.dataclass
class VideoInfo:
    width: int
    height: int
    fps: float
    total_frames: int

    @classmethod
    def from_video_path(cls, path: str) -> "VideoInfo":
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(f"Cannot open video: {path}")
        info = cls(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS)) or 30.0,
            total_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )
        cap.release()
        return info


def frame_generator(path: str, stride: int = 1, start: int = 0,
                    limit: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield BGR frames, every `stride`-th from `start`, at most `limit`."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"Cannot open video: {path}")
    try:
        idx = 0
        yielded = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            if idx >= start and (idx - start) % stride == 0:
                yield frame
                yielded += 1
                if limit is not None and yielded >= limit:
                    return
            idx += 1
    finally:
        cap.release()


def batched(frames: Iterator[np.ndarray], batch: int, stack=np.stack
            ) -> Iterator[Tuple[np.ndarray, int]]:
    """Group frames into (B, H, W, 3) batches; the final batch is padded by
    repeating its last frame so device shapes stay static, and the second
    element is the true frame count. `stack` builds each batch from its
    frames: `np.stack`, or `core/staging.py` `stage`, which writes it into
    page-locked memory. Each stacking is a `stack` range; the range closes
    before the batch is yielded, so it never times the consumer."""
    buf: List[np.ndarray] = []
    for frame in frames:
        buf.append(frame)
        if len(buf) == batch:
            with annotate("stack"):
                out = stack(buf)
            yield out, batch
            buf = []
    if buf:
        n = len(buf)
        buf.extend([buf[-1]] * (batch - n))
        with annotate("stack"):
            out = stack(buf)
        yield out, n


def prefetched(generator, depth: int = 2):
    """Run `generator` on a background thread behind a queue of `depth`
    items, so that video decode overlaps the device's work; an exception
    of the generator is raised to the consumer in its turn
    (hockey_tpu/video/io.py:82)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in generator:
                q.put(item)
            q.put(end)
        except BaseException as e:  # the consumer re-raises it
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def batched_frame_generator(path: str, batch: int, limit: Optional[int] = None
                            ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (B, H, W, 3) uint8 batches of a video's first `limit` frames
    and their true counts."""
    return batched(frame_generator(path, limit=limit), batch)


class VideoSink:
    """mp4 writer (reference: sv.VideoSink)."""

    def __init__(self, path: str, info: VideoInfo):
        self.path = path
        self.info = info
        self._writer = None

    def __enter__(self) -> "VideoSink":
        import cv2

        self._writer = cv2.VideoWriter(
            self.path,
            cv2.VideoWriter_fourcc(*"mp4v"),
            self.info.fps,
            (self.info.width, self.info.height),
        )
        return self

    def write_frame(self, frame: np.ndarray) -> None:
        self._writer.write(frame)

    def __exit__(self, *a) -> None:
        if self._writer is not None:
            self._writer.release()

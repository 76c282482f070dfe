"""The FLOP counter against Ultralytics' published figures (640 x 640, 80
classes: YOLOv8n 8.7, s 28.6, m 79.1, l 165.2, x 257.8 GFLOPs)."""

import pytest

from benchmark.harness.flops import yolov8_flops

SCALES = {"n": (0.33, 0.25, 1024, 8.7), "s": (0.33, 0.50, 1024, 28.6),
          "m": (0.67, 0.75, 768, 79.1), "l": (1.00, 1.00, 512, 165.2),
          "x": (1.00, 1.25, 512, 257.8)}


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_published_gflops(scale):
    d, w, mc, gflops = SCALES[scale]
    got = yolov8_flops(dict(depth_multiple=d, width_multiple=w, max_channels=mc,
                            nc=80), (640, 640)) / 1e9
    assert abs(got - gflops) / gflops < 0.01, (scale, got, gflops)


def test_scales_with_input_area():
    cfg = dict(depth_multiple=1.0, width_multiple=1.25, max_channels=512, nc=2)
    a = yolov8_flops(cfg, (640, 640))
    b = yolov8_flops(cfg, (736, 1280))
    assert abs(b / a - 736 * 1280 / 640 ** 2) < 1e-9

"""The plain reference of YOLOv8 detection, from the published description
(ultralytics/cfg/models/v8/yolov8.yaml: C2f backbone, SPPF, PAN neck,
decoupled DFL head) and a shipped checkpoint's parameter tree.

Every convolution is conv -> BatchNorm with the running statistics
(eps 1e-3) -> SiLU, in float32 with TF32 off, NCHW, with no folding, no
kernel of the program and no interpolation matrices: the letterbox is
F.interpolate, the suppression a greedy loop. With `fp8` set, every
convolution's input and kernel are rounded to float8 e4m3 with a
per-tensor scale first (the control of a bfloat16 program).

Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .msgpack import load_tree

BN_EPS = 1e-3
REG_MAX = 16
STRIDES = (8, 16, 32)
PAD_VALUE = 114.0 / 255.0
CLASS_OFFSET = 1e4
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448)."""
    s = torch.clamp(x.abs().amax(), min=1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Yolo:
    """YOLOv8 over a checkpoint's tree: `raw(x)` maps a (B, 3, H, W) f32
    batch in [0, 1] to the head's per-level (box, cls) maps."""

    def __init__(self, path: str, device, fp8: bool = False):
        tree = load_tree(path)
        self.fp8 = fp8
        self.p = {}
        self._load(tree, "", device)

    def _load(self, node, prefix, device):
        if isinstance(node, dict) and "w" in node:
            w = torch.from_numpy(np.asarray(node["w"], np.float32)).permute(3, 2, 0, 1)
            leaf = {"w": w.contiguous().to(device)}
            if "b" in node:
                leaf["b"] = torch.from_numpy(np.asarray(node["b"], np.float32)).to(device)
            if "bn" in node:
                leaf["bn"] = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                              for k, v in node["bn"].items()}
            self.p[prefix] = leaf
            return
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            self._load(v, f"{prefix}/{k}" if prefix else str(k), device)

    def conv(self, name: str, x: torch.Tensor, stride: int = 1,
             act: bool = True) -> torch.Tensor:
        p = self.p[name]
        w = p["w"]
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        y = F.conv2d(x, w, p.get("b"), stride, w.shape[-1] // 2)
        if "bn" in p:
            bn = p["bn"]
            y = ((y - bn["mean"][:, None, None])
                 * torch.rsqrt(bn["var"] + BN_EPS)[:, None, None]
                 * bn["scale"][:, None, None] + bn["bias"][:, None, None])
        return F.silu(y) if act else y

    def c2f(self, name: str, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
        ys = list(self.conv(f"{name}/cv1", x).chunk(2, dim=1))
        i = 0
        while f"{name}/m/{i}/cv1" in self.p:
            y = self.conv(f"{name}/m/{i}/cv2", self.conv(f"{name}/m/{i}/cv1", ys[-1]))
            ys.append(ys[-1] + y if shortcut else y)
            i += 1
        return self.conv(f"{name}/cv2", torch.cat(ys, 1))

    def sppf(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = [self.conv(f"{name}/cv1", x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        return self.conv(f"{name}/cv2", torch.cat(y, 1))

    def raw(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        y = self.conv("backbone/down1", self.conv("backbone/stem", x, 2), 2)
        y = self.c2f("backbone/c2f1", y, True)
        p3 = self.c2f("backbone/c2f2", self.conv("backbone/down2", y, 2), True)
        p4 = self.c2f("backbone/c2f3", self.conv("backbone/down3", p3, 2), True)
        p5 = self.sppf("backbone/sppf", self.c2f(
            "backbone/c2f4", self.conv("backbone/down4", p4, 2), True))
        t4 = self.c2f("neck/c2f_up1", torch.cat([up(p5), p4], 1), False)
        o3 = self.c2f("neck/c2f_up2", torch.cat([up(t4), p3], 1), False)
        o4 = self.c2f("neck/c2f_d1", torch.cat(
            [self.conv("neck/down_p3", o3, 2), t4], 1), False)
        o5 = self.c2f("neck/c2f_d2", torch.cat(
            [self.conv("neck/down_p4", o4, 2), p5], 1), False)

        def branch(kind, i, f):
            h = self.conv(f"head/{kind}/{i}/cv2", self.conv(f"head/{kind}/{i}/cv1", f))
            return self.conv(f"head/{kind}/{i}/out", h, act=False)

        feats = (o3, o4, o5)
        return ([branch("reg", i, f) for i, f in enumerate(feats)],
                [branch("cls", i, f) for i, f in enumerate(feats)])

    def decode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, H, W) -> (boxes (B, A, 4) xyxy in input px, sigmoid scores
        (B, A, nc)): the DFL box is the softmax expectation over REG_MAX
        bins per side, around each grid cell's centre."""
        box, cls = self.raw(x)
        b = x.shape[0]
        pts, strides = [], []
        for m in box:
            gh, gw = m.shape[2], m.shape[3]
            s = x.shape[2] // gh
            ys, xs = torch.meshgrid(torch.arange(gh, device=x.device) + 0.5,
                                    torch.arange(gw, device=x.device) + 0.5,
                                    indexing="ij")
            pts.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
            strides.append(torch.full((gh * gw,), float(s), device=x.device))
        pts, strides = torch.cat(pts), torch.cat(strides)
        dist = torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, 4, REG_MAX)
                          for m in box], 1)
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=x.device)
        dist = (torch.softmax(dist, -1) * bins).sum(-1)
        boxes = torch.cat([pts - dist[..., :2], pts + dist[..., 2:]], -1)
        scores = torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, m.shape[1])
                            for m in cls], 1)
        return boxes * strides[None, :, None], torch.sigmoid(scores)


def letterbox_geometry(h: int, w: int, imgsz: int, stride: int = 32):
    """(ratio, new_h, new_w, pad_top, pad_left, in_h, in_w) of ultralytics'
    minimal-rectangle letterbox: the long side to imgsz, each side of the
    input rounded up to the stride, the image centred."""
    r = min(imgsz / h, imgsz / w)
    new_h, new_w = round(h * r), round(w * r)
    in_h, in_w = -(-new_h // stride) * stride, -(-new_w // stride) * stride
    pad_top = int(round((in_h - new_h) / 2 - 0.1))
    pad_left = int(round((in_w - new_w) / 2 - 0.1))
    return r, new_h, new_w, pad_top, pad_left, in_h, in_w


def letterbox(frames: torch.Tensor, imgsz: int) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, in_h, in_w) f32 in [0, 1], grey 114
    padding, bilinear resize with half-pixel centres."""
    _, h, w, _ = frames.shape
    _, nh, nw, pt, pl, ih, iw = letterbox_geometry(h, w, imgsz)
    x = frames.permute(0, 3, 1, 2).float()
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    out = torch.full((x.shape[0], 3, ih, iw), PAD_VALUE, device=x.device)
    out[:, :, pt:pt + nh, pl:pl + nw] = x / 255.0
    return out


def _suppression(boxes: torch.Tensor, iou_thr: float, contain_thr: float
                 ) -> torch.Tensor:
    """(K, K) bool: i suppresses j where their IoU exceeds iou_thr or,
    with contain_thr > 0, their intersection over the smaller area exceeds
    contain_thr (boxes class-offset, so classes never meet)."""
    tl = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    br = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    side = torch.clamp(boxes[:, 2:] - boxes[:, :2], min=0.0)
    area = side[:, 0] * side[:, 1]
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-7)
    out = iou > iou_thr
    if contain_thr > 0:
        small = torch.clamp(torch.minimum(area[:, None], area[None, :]), min=1e-9)
        out |= inter / small > contain_thr
    return out


def nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, *,
        conf: float, iou: float, containment: float, pre_topk: int,
        max_det: int, margin: float = 0.0
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[int]]:
    """Greedy class-aware NMS of one frame: boxes (A, 4), scores (A,),
    classes (A,) -> the kept (n, 4), (n,), (n,) in score order, at most
    max_det, and the ranks among the candidates of all that were kept
    above `conf` before that cut. Candidates are the pre_topk best scores
    (ties to the lower index) above `conf` - `margin`: a candidate only
    suppresses those ranked below it, so the ones kept above `conf` are
    those that NMS at `conf` keeps, and the margin adds the kept ones just
    under the floor after them."""
    k = min(pre_topk, scores.shape[0])
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    b, s, c = boxes[order], scores[order], classes[order]
    sup = _suppression(b + c[:, None].float() * CLASS_OFFSET, iou, containment)
    alive = (s > conf - margin).cpu().numpy()
    over = (s > conf).cpu().numpy()
    sup = sup.cpu().numpy()
    kept = []
    for i in range(k):
        if alive[i]:
            kept.append(i)
            alive[i + 1:] &= ~sup[i, i + 1:]
    idx = torch.as_tensor(kept[:max_det], dtype=torch.long, device=boxes.device)
    return b[idx], s[idx], c[idx], [i for i in kept if over[i]]


def tail(kept: List[int], k: int) -> int:
    """Entries of the kept candidates' row tails M[i, i+1:] of a (k, k)
    suppression matrix."""
    return sum(k - 1 - i for i in kept)


class Detector:
    """The reference detector of one configuration: frames -> per frame
    {boxes (n, 4) in frame px, scores (n,), classes (n,), tail}: `tail`
    is the number of entries in the kept candidates' row tails of the
    (K, K) suppression matrix, K = min(pre_topk, anchors), the work that
    greedy suppression needs on this frame at the floor `conf`. With a
    `margin` the detections kept down to `conf` - `margin` are given too.
    """

    def __init__(self, weights: str, device, *, imgsz: int, conf: float,
                 iou: float, containment: float, pre_topk: int, max_det: int,
                 fp8: bool = False, margin: float = 0.0):
        self.model = Yolo(weights, device, fp8)
        self.device = device
        self.margin = margin
        self.imgsz, self.conf, self.iou = imgsz, conf, iou
        self.containment, self.pre_topk, self.max_det = containment, pre_topk, max_det

    @torch.no_grad()
    def __call__(self, frames: np.ndarray) -> List[Dict[str, np.ndarray]]:
        x = torch.as_tensor(np.asarray(frames)).to(self.device)
        h, w = x.shape[1], x.shape[2]
        r, _, _, pt, pl, _, _ = letterbox_geometry(h, w, self.imgsz)
        boxes, scores = self.model.decode(letterbox(x, self.imgsz))
        best, cls = scores.max(-1)
        out = []
        for i in range(x.shape[0]):
            b, s, c, kept = nms(boxes[i], best[i], cls[i], conf=self.conf,
                                iou=self.iou, containment=self.containment,
                                pre_topk=self.pre_topk, max_det=self.max_det,
                                margin=self.margin)
            bx = torch.stack([torch.clamp((b[:, 0] - pl) / r, 0, w),
                              torch.clamp((b[:, 1] - pt) / r, 0, h),
                              torch.clamp((b[:, 2] - pl) / r, 0, w),
                              torch.clamp((b[:, 3] - pt) / r, 0, h)], -1)
            out.append({"boxes": bx.cpu().numpy(), "scores": s.cpu().numpy(),
                        "classes": c.cpu().numpy().astype(np.int32),
                        "tail": tail(kept, min(self.pre_topk, best.shape[1]))})
        return out


def slice_grid(h: int, w: int, size: int, overlap: float) -> List[Tuple[int, int]]:
    """Top-left (y, x) of the size x size tiles that cover (h, w) at
    stride size * (1 - overlap), the last tile flush with the edge."""
    stride = max(int(size * (1.0 - overlap)), 1)

    def starts(total):
        if total <= size:
            return [0]
        return list(range(0, total - size, stride)) + [total - size]

    return [(y, x) for y in starts(h) for x in starts(w)]


class SlicedDetector:
    """The reference of sliced detection: each frame cut into the grid's
    tiles, each tile detected alone (at most `tile_max_det`), the tiles'
    boxes shifted to the frame, then greedy NMS per frame over the best
    `merge_topk` of them at IoU `merge_iou` down to `merge_max_det`; with
    a `margin`, as the Detector's."""

    def __init__(self, weights: str, device, *, size: int, overlap: float,
                 conf: float, iou: float, containment: float, pre_topk: int,
                 tile_max_det: int, merge_iou: float, merge_topk: int,
                 merge_max_det: int, fp8: bool = False, margin: float = 0.0):
        self.tile = Detector(weights, device, imgsz=size, conf=conf, iou=iou,
                             containment=containment, pre_topk=pre_topk,
                             max_det=tile_max_det, fp8=fp8, margin=margin)
        self.size, self.overlap, self.conf = size, overlap, conf
        self.merge_iou, self.merge_topk = merge_iou, merge_topk
        self.merge_max_det = merge_max_det

    def __call__(self, frames: np.ndarray) -> Tuple[List[Dict], List[Dict]]:
        """-> (per-frame merged detections, per-tile detections frame-major
        with their 'offset')."""
        h, w = frames.shape[1:3]
        grid = slice_grid(h, w, self.size, self.overlap)
        launch_k = len(grid) * self.tile.max_det
        s = self.size
        tiles = np.stack([f[y:y + s, x:x + s] for f in frames for y, x in grid])
        per_tile = []
        for i in range(0, len(tiles), 16):
            per_tile += self.tile(tiles[i:i + 16])
        merged = []
        for f in range(len(frames)):
            rows = per_tile[f * len(grid):(f + 1) * len(grid)]
            boxes, scores, classes = [], [], []
            for (y, x), d in zip(grid, rows):
                d["offset"] = (y, x)
                boxes.append(d["boxes"] + np.array([x, y, x, y], np.float32))
                scores.append(d["scores"])
                classes.append(d["classes"])
            b, sc, c, kept = nms(torch.from_numpy(np.concatenate(boxes)),
                              torch.from_numpy(np.concatenate(scores)),
                              torch.from_numpy(np.concatenate(classes)),
                              conf=self.conf, iou=self.merge_iou,
                              containment=0.0, pre_topk=self.merge_topk,
                              max_det=self.merge_max_det, margin=self.tile.margin)
            merged.append({"boxes": b.numpy(), "scores": sc.numpy(),
                           "classes": c.numpy(),
                           "tail": tail(kept, min(self.merge_topk, launch_k))})
        return merged, per_tile

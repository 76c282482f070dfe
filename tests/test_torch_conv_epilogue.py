"""The epilogue of the inference convs (ops/conv_epilogue.py,
csrc/conv_epilogue.cu) and its routing in models/layers.py.

On the CPU: the plain version equals the three ops it stands for (bias
add, SiLU, residual add) bit for bit, in both layouts, with and without
SiLU and a residual, a C2f's `chunk` view among them, at C = 1, 2, 64 and
80; the wrapper runs it on CPU tensors and counts no launch, and raises
on a dtype, shape, layout or device it does not take; `Conv.forward` and
`Bottleneck.forward` on the CPU are bit-equal to the code they replaced;
with the input seen as a CUDA tensor, the inference form reaches the
wrapper once per conv (103 times in a YOLOv8x forward, 63 in a YOLOv8s
one, 72 in the rink YOLOv8s-pose one and 7 in the digit net's, on the
meta device), and a training forward never does.

On the card (skipped without CUDA: the kernel has no CPU mode): the
kernel is bit-equal to the plain version at every conv shape of a YOLOv8x
forward on the classify cell's batch (8 x 736x1280) and of a YOLOv8s
forward on the puck cell's (64 tiles of 640) and of the rink YOLOv8s-pose
forward of the dual step (8 x 512x512), in bf16 and f32, in both
layouts, with a `chunk`-view residual and a contiguous one where the conv
has one; one served YOLOv8x forward on a batch of the cells' frames with
the kernel is bit-equal to the same forward with the plain epilogue and
to the plain ops with the bias inside the conv; and it launches 103 times
a YOLOv8x forward and 63 times a YOLOv8s one; the C entry refuses an
output of 2^31 elements or more; and a profiler trace links each launch
to the `record_function` range it runs in."""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from hockey_tpu_torch.models import layers
from hockey_tpu_torch.models.layers import (BN_EPS, Bottleneck, Conv,
                                            batch_var_mean, fuse_conv_bn,
                                            fuse_model, trainable)
from hockey_tpu_torch.models.yolov8 import MODEL_ZOO, YOLOv8
from hockey_tpu_torch.ops import conv_epilogue as ce

INT_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32}
# (model, batch, network input h, w) of the cells' forwards
CLASSIFY = ("hockey-player-detection", 8, 736, 1280)
PUCK = ("hockey-puck-detection", 64, 640, 640)
POSE = ("hockey-detection", 8, 512, 512)  # the dual step's rink model


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(INT_VIEW[a.dtype]), b.contiguous().view(INT_VIEW[b.dtype]))


def in_layout(t: torch.Tensor, channels_last: bool) -> torch.Tensor:
    return (t.contiguous(memory_format=torch.channels_last) if channels_last
            else t.contiguous())


def operands(shape, dtype, channels_last, residual, device="cpu", seed=0):
    """(y, bias, residual) at `shape` (N, C, H, W): `residual` None, "chunk"
    (the second half of a 2C-channel tensor, as C2f.chunk gives it) or
    "plain" (a tensor of its own), all in the layout."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, c, h, w = shape
    y = in_layout(4 * torch.randn(shape, generator=g, device=device), channels_last)
    bias = torch.randn(c, generator=g, device=device)
    r = None
    if residual == "chunk":
        r = in_layout(torch.randn((n, 2 * c, h, w), generator=g, device=device),
                      channels_last).to(dtype).chunk(2, dim=1)[1]
    elif residual == "plain":
        r = in_layout(torch.randn(shape, generator=g, device=device),
                      channels_last).to(dtype)
    return y.to(dtype), bias.to(dtype), r


def three_ops(y, bias, act, residual):
    """Today's sequence as the forward wrote it."""
    y = y + bias[None, :, None, None] if bias is not None else y
    y = F.silu(y) if act else y
    return y if residual is None else residual + y


@contextlib.contextmanager
def seen_as_cuda(calls=None):
    """Every tensor reads as a CUDA tensor, and the wrapper as seen from
    models/layers.py is a spy that records its calls and runs the plain
    version: the routing runs as on the card, the arithmetic on the CPU
    or the meta device."""
    calls = [] if calls is None else calls

    def spy(y, bias, act, residual=None):
        calls.append((tuple(y.shape), bias, act, residual))
        return ce.conv_epilogue_reference(y, bias, act, residual)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        mp.setattr(layers, "conv_epilogue", spy)
        yield calls


# --------------------------------------------------------------------------
# the plain version and the wrapper on the CPU

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("residual", [None, "chunk", "plain"])
def test_reference_is_the_three_ops(dtype, channels_last, act, residual):
    y, bias, r = operands((2, 16, 5, 7), dtype, channels_last, residual)
    want = three_ops(y.clone(), bias, act, r)
    assert bits_equal(ce.conv_epilogue_reference(y.clone(), bias, act, r), want)


@pytest.mark.parametrize("c", [1, 2, 64, 80])
@pytest.mark.parametrize("channels_last", [True, False])
def test_reference_at_head_and_stem_widths(c, channels_last):
    for dtype in (torch.bfloat16, torch.float32):
        for act, residual in ((True, "chunk"), (False, None), (True, None)):
            y, bias, r = operands((2, c, 4, 6), dtype, channels_last, residual, seed=c)
            assert bits_equal(ce.conv_epilogue_reference(y.clone(), bias, act, r),
                              three_ops(y.clone(), bias, act, r))


@pytest.mark.parametrize("channels_last", [True, False])
def test_cpu_tensors_take_the_plain_version(channels_last):
    ce.epilogue.launches = 0
    y, bias, r = operands((2, 64, 3, 8), torch.bfloat16, channels_last, "chunk")
    got = ce.epilogue(y.clone(), bias, True, r)
    assert bits_equal(got, ce.conv_epilogue_reference(y.clone(), bias, True, r))
    assert ce.epilogue.launches == 0


def test_layouts_the_kernel_sees():
    y, _, r = operands((2, 16, 3, 5), torch.bfloat16, True, "chunk")
    assert ce.check(y, None, None) == ce.Layout(rows=30, len=16, run=1, pitch=16, vec=8)
    assert ce.check(y, None, r) == ce.Layout(rows=30, len=16, run=1, pitch=32, vec=8)
    y, _, r = operands((2, 16, 3, 5), torch.bfloat16, False, "chunk")
    assert ce.check(y, None, r) == ce.Layout(rows=2, len=240, run=15, pitch=480, vec=1)
    # one pixel or one channel: either layout reads the same
    one = torch.zeros(4, 8, 1, 1, dtype=torch.bfloat16)
    assert ce.check(one, None, None) == ce.Layout(rows=4, len=8, run=1, pitch=8, vec=8)
    y32 = torch.zeros(2, 6, 3, 5).contiguous(memory_format=torch.channels_last)
    assert ce.check(y32, None, None).vec == 1  # 6 f32 channels: no whole vector


@pytest.mark.parametrize("c,hw,channels_last,want", [
    (64, (4, 4), True, True),     # 8 bf16 channels a vector
    (80, (3, 5), True, True),
    (2, (4, 4), True, False),     # the class conv: one element at a time
    (1, (4, 4), True, False),
    (8, (4, 4), False, True),     # NCHW: H*W = 16 holds whole vectors
    (8, (3, 5), False, False),    # H*W = 15 does not
])
def test_vector_path_follows_the_shape(c, hw, channels_last, want):
    y, bias, _ = operands((2, c, *hw), torch.bfloat16, channels_last, None)
    assert ce.vectorized(y, bias, None, ce.check(y, bias, None)) is want


def test_vector_path_needs_aligned_pointers():
    base = torch.zeros(2 * 64 * 16 + 1, dtype=torch.bfloat16)
    y = base[1:].view(2, 4, 4, 64).permute(0, 3, 1, 2)  # channels_last, 2 bytes off
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert not ce.vectorized(y, None, None, ce.check(y, None, None))
    _, _, r = operands((2, 64, 4, 4), torch.float32, True, "chunk")
    y32 = torch.zeros(2, 64, 4, 4).contiguous(memory_format=torch.channels_last)
    assert ce.vectorized(y32, None, r, ce.check(y32, None, r))  # 4 f32 a vector


def _bad_cases():
    y, bias, r = operands((2, 16, 3, 5), torch.bfloat16, True, "chunk")
    nchw_r = operands((2, 16, 3, 5), torch.bfloat16, False, "plain")[2]
    return {
        "f64": (y.double(), bias.double(), None, TypeError),
        "int": (y.to(torch.int32), None, None, TypeError),
        "bias dtype": (y, bias.float(), None, TypeError),
        "3-d": (y[0], bias, None, ValueError),
        "bias length": (y, bias[:8], None, ValueError),
        "residual shape": (y, bias, r[:, :8], ValueError),
        "strided output": (y[:, :, :, ::2], bias, None, ValueError),
        "residual layout": (y, bias, nchw_r, ValueError),
        "residual is the output": (y, bias, y, ValueError),
        "bias strided": (y, torch.randn(32).to(torch.bfloat16)[::2], None, ValueError),
        "meta device": (y.to("meta"), bias.to("meta"), None, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_wrapper_raises_on_what_it_does_not_take(case):
    y, bias, r, err = _bad_cases()[case]
    with pytest.raises(err):
        ce.epilogue(y, bias, True, r)


def test_wrapper_raises_where_grad_is_wanted():
    y, bias, _ = operands((2, 16, 3, 5), torch.float32, True, None)
    with pytest.raises(RuntimeError, match="grad"):
        ce.epilogue(y, bias.requires_grad_(), True)
    with torch.no_grad():  # nothing to record: the plain version runs
        ce.epilogue(y, bias, True)


def test_bound_bytes():
    y, bias, r = operands((2, 16, 3, 5), torch.bfloat16, True, "chunk")
    assert ce.bound_bytes(y) == 2 * 480 * 2
    assert ce.bound_bytes(y, bias, r) == 2 * 480 * 2 + 480 * 2 + 16 * 2


# --------------------------------------------------------------------------
# models/layers.py on the CPU: the code it replaced, and the routing

def replaced_conv_forward(conv, x, stats=None):
    """Conv.forward as it was before the epilogue kernel."""
    b = None if conv.b is None else conv.b.to(x.dtype)
    y = F.conv2d(x, conv.w.to(x.dtype), b, conv.stride, conv.pad)
    if conv.bn is not None:
        if stats is None:
            scale, bias = conv.bn.folded()
        else:
            var, mean = batch_var_mean(y.float(), stats)
            stats.append((conv.path, mean.detach(), var.detach()))
            scale = conv.bn.scale * torch.rsqrt(var + BN_EPS)
            bias = conv.bn.bias - mean * scale
        y = (y * scale.to(y.dtype)[:, None, None]
             + bias.to(y.dtype)[:, None, None])
    return F.silu(y) if conv.act else y


def random_conv(cin, cout, k, seed, **kw):
    torch.manual_seed(seed)
    conv = Conv(cin, cout, k, **kw)
    with torch.no_grad():
        conv.w.normal_(0, 0.3)
        if conv.b is not None:
            conv.b.normal_()
        if conv.bn is not None:
            conv.bn.scale.uniform_(0.5, 1.5)
            conv.bn.bias.normal_()
            conv.bn.mean.normal_()
            conv.bn.var.uniform_(0.5, 2.0)
    return conv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["fused", "bn", "head", "training"])
def test_conv_forward_on_the_cpu_is_the_replaced_code(dtype, form):
    kw = dict(bn=False, bias=True, act=False) if form == "head" else {}
    conv = random_conv(16, 24, 3, seed=1, **kw)
    if form == "fused":
        fuse_conv_bn(conv)
    x = torch.randn(2, 16, 9, 11).contiguous(memory_format=torch.channels_last)
    conv, x = conv.to(dtype), x.to(dtype)
    if form == "training":
        trainable(conv)
        s_got, s_want = [], []
        got = conv(x, s_got)
        want = replaced_conv_forward(conv, x, s_want)
        assert [p for p, *_ in s_got] == [p for p, *_ in s_want]
        assert all(torch.equal(a, b) for (_, *g), (_, *w) in zip(s_got, s_want)
                   for a, b in zip(g, w))
        assert got.requires_grad
    else:
        with torch.no_grad():
            got, want = conv(x), replaced_conv_forward(conv, x)
    assert bits_equal(got.detach(), want.detach())


@pytest.mark.parametrize("add", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bottleneck_on_the_cpu_is_the_replaced_code(add, dtype):
    torch.manual_seed(2)
    m = Bottleneck(16, 16, add)
    for conv in (m.cv1, m.cv2):
        conv.w.normal_(0, 0.2)
        conv.bn.bias.normal_()
        fuse_conv_bn(conv)
    m = m.to(dtype)
    x = torch.randn(2, 32, 6, 7).contiguous(memory_format=torch.channels_last)
    x = x.to(dtype).chunk(2, dim=1)[1]  # the C2f's view
    with torch.no_grad():
        y = replaced_conv_forward(m.cv2, replaced_conv_forward(m.cv1, x))
        assert bits_equal(m(x), x + y if add else y)


def test_inference_form_reaches_the_wrapper_once_per_conv():
    conv = fuse_conv_bn(random_conv(16, 24, 3, seed=3))
    x = torch.randn(2, 16, 9, 11).contiguous(memory_format=torch.channels_last)
    with torch.no_grad(), seen_as_cuda() as calls:
        got = conv(x)
    assert len(calls) == 1
    shape, bias, act, residual = calls[0]
    assert shape == (2, 24, 9, 11) and bias is not None and act and residual is None
    # the conv ran without its bias, which the epilogue then added
    assert bits_equal(got, three_ops(
        F.conv2d(x, conv.w, None, 1, 1), conv.b, True, None))


def test_bottleneck_hands_its_input_to_the_epilogue():
    m = Bottleneck(16, 16, True)
    for conv in (m.cv1, m.cv2):
        fuse_conv_bn(conv)
    x = torch.randn(2, 32, 6, 7).contiguous(memory_format=torch.channels_last)
    x = x.chunk(2, dim=1)[1]
    with torch.inference_mode(), seen_as_cuda() as calls:
        m(x)
    assert [c[3] is x for c in calls] == [False, True]


@pytest.mark.parametrize("case", ["stats", "grad", "bn"])
def test_training_forwards_never_reach_the_wrapper(case):
    conv = random_conv(16, 24, 3, seed=4)
    x = torch.randn(2, 16, 9, 11).contiguous(memory_format=torch.channels_last)
    if case == "bn":  # the unfused form keeps its BN ops, grad or not
        with torch.no_grad(), seen_as_cuda() as calls:
            conv(x)
    else:
        trainable(conv)
        if case == "grad":  # folded, but its weights want gradients
            conv = fuse_conv_bn(conv)
            conv.w.requires_grad_()
        with seen_as_cuda() as calls:
            y = conv(x, [] if case == "stats" else None)
            y.float().sum().backward()
    assert calls == []


def conv_calls(name: str, batch: int, h: int, w: int):
    """(shape, act, has residual) of every epilogue of one forward of the
    served (folded) model `name` at (batch, 3, h, w), traced on the meta
    device with the routing of the card."""
    with torch.device("meta"):
        model = fuse_model(YOLOv8(MODEL_ZOO[name]))
        x = torch.empty(batch, 3, h, w).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode(), seen_as_cuda() as calls:
        model(x)
    return [(shape, act, r is not None) for shape, _, act, r in calls]


@pytest.mark.parametrize("cell,convs,residuals", [(CLASSIFY, 103, 18), (PUCK, 63, 6)])
def test_every_conv_of_a_forward_reaches_the_wrapper(cell, convs, residuals):
    calls = conv_calls(*cell)
    assert len(calls) == convs
    assert sum(r for *_, r in calls) == residuals  # the backbone's bottlenecks
    assert sum(not act for _, act, _ in calls) == 6  # the head's output convs


def test_every_conv_of_the_rink_pose_forward_reaches_the_wrapper():
    calls = conv_calls(*POSE)
    assert len(calls) == 72
    assert sum(r for *_, r in calls) == 6
    assert sum(not act for _, act, _ in calls) == 9  # box, class and keypoint maps


def test_every_conv_of_the_digit_net_reaches_the_wrapper():
    from hockey_tpu_torch.ocr.digits import DigitNet
    net = DigitNet().eval()
    x = torch.rand(3, 48, 48, 1)
    with torch.inference_mode(), seen_as_cuda() as calls:
        net(x)
    assert [act for _, _, act, _ in calls] == [True] * 5 + [False] * 2
    assert all(b is not None and r is None for _, b, _, r in calls)


# --------------------------------------------------------------------------
# the card: the kernel against the plain version

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the epilogue kernel has no CPU mode")
    ce.epilogue.launches = 0
    return torch.device("cuda")


@pytest.mark.parametrize("cell", [CLASSIFY, PUCK, POSE],
                         ids=["yolov8x", "yolov8s", "yolov8s-pose"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("channels_last", [True, False])
def test_kernel_is_bit_equal_at_every_conv_shape(card, cell, dtype, channels_last):
    shapes = sorted(set(conv_calls(*cell)))
    launches = 0
    for i, (shape, act, has_res) in enumerate(shapes):
        for residual in (("chunk", "plain") if has_res else (None,)):
            y, bias, r = operands(shape, dtype, channels_last, residual, card, seed=i)
            with torch.inference_mode():
                want = ce.conv_epilogue_reference(y.clone(), bias, act, r)
                got = ce.epilogue(y, bias, act, r)
            launches += 1
            assert got.data_ptr() == y.data_ptr()  # in place
            assert bits_equal(got, want), (shape, act, residual)
    torch.cuda.synchronize()
    assert ce.epilogue.launches == launches


def served_forward(name: str, batch: torch.Tensor):
    from hockey_tpu_torch.models.detector import served_model
    from hockey_tpu_torch.models.yolov8 import forward_raw
    model = served_model(name, None, batch.device, torch.bfloat16)
    with torch.inference_mode():
        return forward_raw(model, batch)


def cell_batch(card):
    """One batch of the cells' frames, letterboxed as the detect step does."""
    from benchmark.traffic.scenes import synthetic_frames
    from hockey_tpu_torch.ops.letterbox import letterbox_rect_batch
    frames = torch.as_tensor(synthetic_frames(seed=5, n=8)).to(card)
    return letterbox_rect_batch(frames, 1280, 32, torch.bfloat16)


def test_served_forward_is_bit_equal_to_the_plain_epilogue(card, monkeypatch):
    x = cell_batch(card)
    assert tuple(x.shape) == (8, 736, 1280, 3)
    got = served_forward(CLASSIFY[0], x)
    assert ce.epilogue.launches == 103
    monkeypatch.setattr(layers, "conv_epilogue", ce.conv_epilogue_reference)
    plain = served_forward(CLASSIFY[0], x)
    monkeypatch.setattr(layers, "on_card_inference", lambda *a: False)
    replaced = served_forward(CLASSIFY[0], x)  # the bias inside F.conv2d
    for key, maps in got.items():
        for a, b, c in zip(maps, plain[key], replaced[key]):
            assert bits_equal(a, b) and bits_equal(a, c), key


def test_launches_per_forward(card):
    tiles = torch.zeros(PUCK[1], 640, 640, 3, dtype=torch.bfloat16, device=card)
    served_forward(PUCK[0], tiles)
    assert ce.epilogue.launches == 63
    served_forward(CLASSIFY[0], cell_batch(card))
    assert ce.epilogue.launches == 63 + 103


def test_entry_refuses_outputs_of_2_31_elements(card):
    fn = ce.epilogue.load()
    stream = torch.cuda.current_stream().cuda_stream
    # checked before any memory is touched: the pointer is never read
    for rows, length in ((2 ** 16, 2 ** 15), (2 ** 31, 1), (1, 2 ** 31)):
        assert fn(16, None, None, 1, rows, length, 1, length, 1, 1, 0, stream) == 1


def test_profiler_links_launches_to_the_range(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    y, bias, r = operands((8, 256, 92, 160), torch.bfloat16, True, "chunk", card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode(), record_function("forward"):
            ce.epilogue(y, bias, True, r)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernel_us = sum(e.self_device_time_total for e in events
                    if "conv_epilogue_kernel" in e.key)
    range_us = sum(e.device_time_total for e in events
                   if e.key == "forward" and e.device_type == DeviceType.CPU)
    assert kernel_us > 0 and range_us >= kernel_us

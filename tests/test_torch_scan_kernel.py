"""The device tracker's CUDA kernel (tracking/scan_kernel.py,
csrc/tracker_scan.cu) and the routing of `tracker_scan`.

On the CPU: CPU tensors take the plain version and launch nothing; any
other device goes to the kernel's wrapper, which raises, never falls back,
on a device, dtype, shape or size it does not take; a stub launch shows
what the wrapper hands the kernel and that its counters advance.

On the card (skipped without CUDA: the kernel has no CPU mode): the kernel
against the plain `tracker_scan_reference` on the CPU over the same
inputs, at the main path's shapes (T = 128, D = 64, batches of 8) under
each setting of the extension knobs, on a crowded scene, at
`DeviceByteTrack`'s shapes (T = 64, one frame, D = 8 to 16) on the
tracker scenarios, and at the widest shapes the port produces. Track ids,
emitted ids and every integer and boolean field equal; the auction rounds
and fill steps the kernel counts equal the plain solver's; mean, cov and
score within rtol 1e-5 and atol 1e-4 (the update's 4x4 solve and products
round in another order than LAPACK's and the CPU's einsum; each state is
carried on its own side through every batch)."""

import numpy as np
import pytest
import torch

from hockey_tpu_torch.ops import assignment
from hockey_tpu_torch.tracking import device_tracker as tdt
from hockey_tpu_torch.tracking import scan_kernel as sk
from chip_smoke import crowded_sequence
from tests.tracker_cases import (D_MAIN, DEVICE_SCENARIOS, SETTINGS, T_MAIN,
                                 config_kwargs, scenario_frames,
                                 tracker_sequence)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tracker kernel has no CPU mode")
    sk.scan.reset()
    return torch.device("cuda")


def _batches(data, b):
    k = data[0].shape[0]
    return [tuple(torch.from_numpy(x[s:s + b]) for x in data)
            for s in range(0, k, b)]


def _meta_inputs(b=8, t=T_MAIN, d=D_MAIN):
    state = tdt.init_state(t, "cpu")
    state = tdt.TrackState(*(x.to("meta") for x in state))
    return state, (torch.zeros(b, d, 4, device="meta"),
                   torch.zeros(b, d, device="meta"),
                   torch.zeros(b, d, dtype=torch.int32, device="meta"),
                   torch.zeros(b, d, dtype=torch.bool, device="meta"))


# --------------------------------------------------------------------------
# the CPU: routing, checks, a stub launch

def test_cpu_tensors_take_the_plain_version():
    kw = config_kwargs()
    data = _batches(tracker_sequence(0, 8, D_MAIN), 8)[0]
    launches = sk.scan.launches
    st = assignment.stats
    syncs = st.syncs
    got_state, got = tdt.tracker_scan(tdt.init_state(T_MAIN, "cpu"), *data, **kw)
    want_state, want = tdt.tracker_scan_reference(
        tdt.init_state(T_MAIN, "cpu"), *data, **kw)
    assert torch.equal(got, want)
    for a, b in zip(got_state, want_state):
        assert torch.equal(a, b)
    assert sk.scan.launches == launches  # nothing launched
    assert st.syncs > syncs               # the plain auction's host syncs


def test_other_devices_go_to_the_kernel_and_raise():
    """No fallback: tensors on a device other than the CPU reach the
    kernel's wrapper, which takes CUDA alone."""
    state, data = _meta_inputs()
    with pytest.raises(ValueError, match="not CUDA"):
        tdt.tracker_scan(state, *data, **config_kwargs())


@pytest.mark.parametrize("case", ["slots_257", "smem_256x256", "no_dets",
                                  "f64_boxes", "i64_classes", "state_shape",
                                  "strided_scores"])
def test_wrapper_raises_beyond_its_limits(case):
    b, t, d = 8, T_MAIN, D_MAIN
    if case == "slots_257":
        t = 257
    if case == "smem_256x256":
        t, d = 256, 256
    if case == "no_dets":
        d = 0
    state, (boxes, scores, classes, valid) = _meta_inputs(b, t, d)
    if case == "f64_boxes":
        boxes = boxes.double()
    if case == "i64_classes":
        classes = classes.long()
    if case == "state_shape":
        state = state._replace(cov=torch.zeros(t, 8, 4, device="meta"))
    if case == "strided_scores":
        scores = torch.zeros(b, 2 * d, device="meta")[:, ::2]
    err = TypeError if case in ("f64_boxes", "i64_classes") else ValueError
    with pytest.raises(err, match="tracker_scan kernel"):
        tdt.tracker_scan(state, boxes, scores, classes, valid, **config_kwargs())


def test_shared_memory_limit():
    """The stated limit: the main path (128 x 64), DeviceByteTrack at the
    main path's slots with up to 256 padded detections, and 256 slots by
    the main path's 64 detections fit; 256 x 256 does not."""
    assert sk.smem_bytes(T_MAIN, D_MAIN) == 40704
    for t, d in ((128, 64), (128, 256), (64, 256), (256, 64), (256, 200)):
        assert sk.smem_bytes(t, d) <= sk.MAX_SMEM, (t, d)
    assert sk.smem_bytes(256, 256) > sk.MAX_SMEM


class _StubKernel(sk.ScanKernel):
    def __init__(self):
        super().__init__()
        self.args = []

    def _launch(self, args, device):
        self.args.append({f: getattr(args, f) for f, _ in args._fields_})


@pytest.mark.parametrize("setting", ["config_defaults", "lost_reacquire_floor",
                                     "init_contain_veto", "stock_bytetrack"])
def test_stub_launch_counts_and_arguments(monkeypatch, setting):
    stub = _StubKernel()
    monkeypatch.setattr(tdt, "scan_kernel", stub)
    kw = {**config_kwargs(), **SETTINGS[setting]}
    state, data = _meta_inputs(8)
    new, tids = tdt.tracker_scan(state, *data, **kw)
    tdt.tracker_scan(new, *_meta_inputs(3)[1], **kw)
    assert (stub.launches, stub.frames) == (2, 11)
    assert isinstance(new, tdt.TrackState) and tids.shape == (8, D_MAIN)
    assert all(a.shape == b.shape and a.dtype == b.dtype
               for a, b in zip(new, state))
    a = stub.args[0]
    assert (a["B"], a["T"], a["D"]) == (8, T_MAIN, D_MAIN)
    assert a["smem"] == sk.smem_bytes(T_MAIN, D_MAIN)
    assert stub.args[1]["B"] == 3
    f32 = np.float32
    assert a["gate1"] == f32(1.0 - kw["match_thresh"])
    assert a["gate2"] == f32(1.0 - tdt.STEP_DEFAULTS["low_gate"])
    assert a["activation_thresh"] == f32(kw["activation_thresh"])
    assert a["eps"] == f32(assignment.AUCTION_EPS)
    assert a["max_rounds"] == assignment.AUCTION_MAX_ROUNDS
    assert (a["max_time_lost"], a["min_consecutive"]) == (
        kw["max_time_lost"], kw["min_consecutive"])
    on = {"stage3": "lost_reacquire_floor", "contain_veto": "init_contain_veto",
          "dup_kill": "duplicate_kill_iomin",
          "lost_dup_kill": "lost_dup_kill_iomin"}
    for flag, key in on.items():
        assert a[flag] == int(kw.get(key, 0.0) > 0.0), flag


# --------------------------------------------------------------------------
# the card: the kernel against the plain version

def _assert_states(got: tdt.TrackState, want: tdt.TrackState, where=""):
    for f in ("track_id", "active", "tracked", "activated", "missed",
              "consecutive", "next_id", "class_id"):
        g, w = getattr(got, f).cpu(), getattr(want, f)
        assert g.dtype == w.dtype, f
        assert torch.equal(g, w), f"{f} {where}"
    for f in ("mean", "cov", "score"):
        np.testing.assert_allclose(getattr(got, f).cpu().numpy(),
                                   getattr(want, f).numpy(), rtol=1e-5,
                                   atol=1e-4, err_msg=f"{f} {where}")


def _against_plain(dev, data, kw, t, b=8):
    """Both sides over the batches of `data`, each carrying its own state;
    returns (ids emitted, the plain solver's rounds and fill steps)."""
    st = assignment.stats
    st.rounds = st.fill_steps = 0
    ref = tdt.init_state(t, "cpu")
    got = tdt.init_state(t, dev)
    emitted = 0
    batches = _batches(data, b)
    for n, x in enumerate(batches):
        ref, want = tdt.tracker_scan(ref, *x, **kw)
        got, tids = tdt.tracker_scan(got, *(v.to(dev) for v in x), **kw)
        assert torch.equal(tids.cpu(), want), f"batch {n}"
        _assert_states(got, ref, f"batch {n}")
        emitted += int((want >= 0).sum())
    torch.cuda.synchronize()
    assert sk.scan.launches == len(batches)
    assert sk.scan.frames == data[0].shape[0]
    return emitted, st.rounds, st.fill_steps


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_kernel_matches_plain_at_main_path_shapes(card, setting):
    """48 frames at T = 128, D = 64 in 6 launches of 8 frames."""
    kw = {**config_kwargs(), **SETTINGS[setting]}
    emitted, rounds, fills = _against_plain(
        card, tracker_sequence(0, 48, D_MAIN), kw, T_MAIN)
    assert emitted > 300
    assert sk.scan.counts(card) == {"rounds": rounds, "fill_steps": fills}


@pytest.mark.parametrize("setting", ["config_defaults", "stock_bytetrack",
                                     "lost_reacquire_floor", "init_contain_veto"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_on_a_crowd(card, setting, seed):
    """22 overlapping boxes a frame: many auction rounds and fill steps."""
    kw = {**config_kwargs(), **SETTINGS[setting]}
    emitted, rounds, fills = _against_plain(
        card, crowded_sequence(seed, 16, D_MAIN), kw, T_MAIN)
    assert emitted > 100 and rounds > 40 and fills > 5
    assert sk.scan.counts(card) == {"rounds": rounds, "fill_steps": fills}


@pytest.mark.parametrize("t,d,k", [(256, 64, 16), (256, 200, 8), (64, 256, 8),
                                   (33, 7, 8)])
def test_kernel_matches_plain_at_other_shapes(card, t, d, k):
    """The widest shapes the port produces (256 slots; DeviceByteTrack's
    padding of 200 detections at 256) and odd ones."""
    data = crowded_sequence(2, k, d, n_targets=min(d, 22))
    _against_plain(card, data, config_kwargs(), t)


@pytest.mark.parametrize("name", DEVICE_SCENARIOS)
def test_device_bytetrack_on_the_card(card, name):
    """DeviceByteTrack on the card against DeviceByteTrack on the CPU, frame
    by frame: one launch of one frame per update."""
    kw, frames = scenario_frames(name)
    ours = tdt.DeviceByteTrack(device=card, **kw)
    ref = tdt.DeviceByteTrack(device="cpu", **kw)
    for i, fr in enumerate(frames):
        got, want = ours.update(*fr), ref.update(*fr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
        np.testing.assert_array_equal(ours.last_indices, ref.last_indices)
    _assert_states(ours.state, ref.state, "end")
    assert (sk.scan.launches, sk.scan.frames) == (len(frames), len(frames))


@pytest.mark.parametrize("name", ["occlusion_gap", "expiry", "low_score",
                                  "lost_reacquire_on", "crossing_occlusion",
                                  "duplicate_alternation_kill",
                                  "duplicate_alternation_veto"])
def test_kernel_matches_plain_on_scenarios(card, name):
    """The scenarios as one padded sequence (D = 16, T = 64) in one launch."""
    kw, frames = scenario_frames(name)
    k, d = len(frames), 16
    data = (np.zeros((k, d, 4), np.float32), np.full((k, d), -1.0, np.float32),
            np.zeros((k, d), np.int32), np.zeros((k, d), bool))
    for f, fr in enumerate(frames):
        n = len(fr[0])
        data[0][f, :n], data[1][f, :n], data[3][f, :n] = fr[0], fr[1], True
    skw = tdt.DeviceByteTrack(device="cpu", capacity=1, **kw).kwargs
    emitted, _, _ = _against_plain(card, data, skw, 64, b=k)
    assert emitted > 0

#!/usr/bin/env python3
"""The mesh across the cards of one host: `chip_smoke.py` phase 15's (b)
and (c) alone, at more than one shape, and the train CLI's own launch.

    python3 scripts/torch_mesh_check.py [--profile] [--out F.json]

Needs two cards or more (NCCL). It runs (b) (MESH_STEPS steps of the
shipped YOLOv8x at 640, batch 16, bf16 on one card, `Trainer` against a
1x1 mesh) and then, one process per card through `chip_smoke.py
--mesh-rank`, dp 2, and with four cards dp 2 x fsdp 2 and dp 4, each
held against (b)'s steps and phase 4's detections by phase 15 (c)'s
tolerances. Then `python -m hockey_tpu_torch.train.loop` with `--dp 2`
(and `--fsdp 2` on four cards), which starts its own processes, against
the same CLI with `--dp 1` on one card: both from the shipped weights,
with `--ema` and `--device-data` given (the mesh turns them off), the
checkpoints within MULTI_PARAM_TOL of each leaf's scale. With
`--profile`, torch.profiler then splits a step of one card (16 images)
and of each mesh's rank 0 (`--profile-rank`): wall and device ms per
step, the NCCL kernels' ms, launches and the largest kernels. Prints each
result and the card line, and writes them as one JSON object to --out.
"""

import argparse
import json
import time
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

PROFILED_STEPS = 3


def profile_steps(trainer, batch, steps=PROFILED_STEPS):
    """Two warm-up steps, then `steps` profiled ones: wall ms per step
    (host clock around synchronised steps), device ms per step (every
    CUDA kernel's own time; the ranges that `record_function` and NCCL's
    collectives put on the device's timeline are left out), the NCCL
    kernels' share, launches per step and the 8 largest kernels."""
    for _ in range(2):
        trainer.step(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.step(batch)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / steps
    cuda = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("nccl:")]
    per = {e.key: e.self_device_time_total / 1e3 / steps for e in cuda}
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms_per_step": round(wall, 3),
            "device_ms_per_step": round(sum(per.values()), 3),
            "nccl_ms_per_step": round(sum(v for k, v in per.items()
                                          if "nccl" in k.lower()), 3),
            "launches_per_step": sum(e.count for e in cuda) / steps,
            "top_kernels_ms": [(k[:80], round(v, 3)) for k, v in top]}


def profile_rank(inp: str, res: str) -> int:
    """One rank of a profiled mesh step (`--profile-rank IN OUT`, started
    by `launch`): (b)'s model and first batch, this rank's rows."""
    with np.load(inp, allow_pickle=False) as f:
        data = dict(f)
    device = C.init_from_env("cuda")
    mesh = C.make_mesh(dist.get_world_size(), fsdp=int(data["fsdp"]), device=device)
    batch = C.shard_batch(mesh, {k: torch.from_numpy(data[k]) for k in
                                 ("images", "boxes", "classes", "mask")})
    trainer = C.shard_train_step(mesh, C.MODEL_ZOO["hockey-player-detection"],
                                 C.mesh_train_config(), C.mesh_model(device))
    out = profile_steps(trainer, batch)
    if mesh.rank == 0:
        with open(res, "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def profiles(batch, shapes):
    """`profile_steps` of one card's `Trainer` on `batch` and of rank 0 of
    each (dp, fsdp) mesh on its rows."""
    out = {"one_card": profile_steps(
        C.Trainer(C.MODEL_ZOO["hockey-player-detection"], C.mesh_train_config(),
                  C.mesh_model("cuda")), batch)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        inp, res = os.path.join(d, "in.npz"), os.path.join(d, "out.json")
        for dp, fsdp in shapes:
            np.savez(inp, fsdp=fsdp, **{k: v.cpu().numpy() for k, v in batch.items()})
            rc = C.launch([os.path.abspath(__file__), "--profile-rank", inp, res],
                          dp * fsdp, "cuda", timeout=900)
            if rc != 0:
                raise AssertionError(f"a profiled rank failed ({rc})")
            with open(res) as f:
                out[f"dp{dp}_fsdp{fsdp}_rank0"] = json.load(f)
    print(f"profiles: {out}", flush=True)
    return out


def cli_runs(n_cards: int):
    """The train CLI on the mesh (its own launch) against one card."""
    name = "hockey-player-detection"
    fsdp = 2 if n_cards >= 4 else 1
    with tempfile.TemporaryDirectory() as d:
        frames, boxes = C.square_players(seed=41, n=32)
        vframes, vboxes = C.square_players(seed=42, n=8)
        pool, val = os.path.join(d, "pool.npz"), os.path.join(d, "val.npz")
        C.write_pool(pool, frames, boxes)
        C.write_pool(val, vframes, vboxes)
        common = ["-m", "hockey_tpu_torch.train.loop", "--model", name,
                  "--imgsz", "640", "--batch", "16", "--steps", "3",
                  "--init", C.shipped_weights_path(name), "--lr", str(C.MESH_LR),
                  "--warmup", "1", "--pool-file", pool, "--val-pool-file", val,
                  "--val-size", "8", "--val-every", "3", "--log-every", "1",
                  "--save-every", "0", "--seed", "5"]
        out = {}
        for tag, extra in (("mesh", ["--dp", "2", "--fsdp", str(fsdp), "--ema", "0.999",
                                     "--device-data"]),
                           ("one", ["--dp", "1", "--precise-bn", "0"])):
            ckpt = os.path.join(d, f"{tag}.msgpack")
            env = dict(os.environ)
            if tag == "one":
                env["CUDA_VISIBLE_DEVICES"] = "0"
            proc = subprocess.run([sys.executable, *common, *extra, "--out", ckpt],
                                  cwd=ROOT, env=env, capture_output=True, text=True,
                                  timeout=900)
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            if proc.returncode != 0:
                raise AssertionError(f"the {tag} CLI run failed ({proc.returncode})")
            out[tag] = {"log_tail": proc.stdout.strip().splitlines()[-4:],
                        "tree": C.flat(C.load_params(ckpt))}
        diff = C.tree_diff(out["mesh"]["tree"], out["one"]["tree"])
        res = {"mesh": f"dp 2 x fsdp {fsdp}", "param_max_diff": diff,
               "mesh_log_tail": out["mesh"]["log_tail"],
               "one_log_tail": out["one"]["log_tail"]}
        print(f"train CLI on the mesh against one card: {res}", flush=True)
        if diff > C.MULTI_PARAM_TOL:
            raise AssertionError(f"the CLI's mesh checkpoint differs: {diff}")
        return res


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--profile-rank", nargs=2, metavar=("IN", "OUT"))
    args = p.parse_args()
    if args.profile_rank:
        return profile_rank(*args.profile_rank)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_mesh_check: needs two CUDA cards or more", file=sys.stderr)
        return 2
    n = torch.cuda.device_count()
    card = C.card_line()
    print(card, f"x {n}", flush=True)
    config = C.Config()
    det = C.Detector(config.player_model_name, config, frame_hw=C.FRAME_HW,
                     device="cuda", dtype=torch.bfloat16)
    frames8 = C.synthetic_frames(seed=0, n=C.BATCH)
    ref = det.detect_batch(frames8)
    dets8 = [d for d, _, _ in C.fetch(C.pack(ref)).rows()]
    batches = C.mesh_batches(C.MESH_STEPS, "cuda")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{C.free_port()}",
                            world_size=1, rank=0)
    try:
        train, want, want_tree = C.mesh_steps(
            C.make_mesh(1, device=torch.device("cuda", 0)), batches)
    finally:
        dist.destroy_process_group()
    del det
    torch.cuda.empty_cache()  # rank 0 shares this process's card
    shapes = [(2, 1)] + ([(2, 2), (4, 1)] if n >= 4 else [])
    meshes = [C.multi_card(batches, want, want_tree, frames8, dets8, dp=dp, fsdp=f)
              for dp, f in shapes]
    res = {"card": card, "count": n, "train_1x1": train, "meshes": meshes,
           "train_cli": cli_runs(n)}
    if args.profile:
        res["profiles"] = profiles(batches[0], shapes)
    print(json.dumps(res, default=float), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())

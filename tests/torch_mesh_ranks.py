"""The body of one rank of tests/test_torch_sharding.py's 4-process gloo
mesh (dp 2 x fsdp 2), on the CPU:

    python -m tests.torch_mesh_ranks IN.npz OUT.npz

(started by `hockey_tpu_torch.core.mesh.launch`, which sets the rank's
environment). It imports no JAX. From `init_params(seed=0)` of YOLOv8n it
runs two `shard_train_step` steps on the two global batches in IN (each
rank on its dp rows), then one step of each of two trainers that keep a
per-rank quantity (BN statistics; the loss normalisers, averaged over dp
as data-parallel training without them would), then `detect_dp` on IN's
frames. Rank 0 writes OUT: each step's metrics, the parameters and the
momentum after the two steps (JAX layout, '/'-joined paths), the other
trainers' losses, the gathered detections, every rank's mesh coordinates,
and the largest difference of any rank's parameters from rank 0's.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from hockey_tpu_torch.core.mesh import init_from_env, make_mesh, shard_batch
from hockey_tpu_torch.models.checkpoint import flatten_tree
from hockey_tpu_torch.models.detector import DetectCore
from hockey_tpu_torch.models.layers import fuse_for_inference
from hockey_tpu_torch.models.yolov8 import (YoloConfig, build_model, init_params,
                                            params_to_jax)
from hockey_tpu_torch.parallel.sharding import ShardedTrainer, detect_dp, shard_train_step
from hockey_tpu_torch.train.trainer import TrainConfig

CFG = YoloConfig("n", num_classes=2)
TC = dict(imgsz=64, total_steps=10, warmup_steps=2, compute_dtype="float32")
KEYS = ("images", "boxes", "classes", "mask")
DETECT = dict(imgsz=64, frame_hw=(48, 96), conf=0.001, pre_topk=32, max_det=8,
              dtype=torch.float32)


class LocalStatsTrainer(ShardedTrainer):
    """Each rank's BN normalises by its own rows' statistics."""

    def _stats(self):
        return []


class LocalNormTrainer(ShardedTrainer):
    """Each rank's loss is normalised by its own rows' sums, and the dp
    sum of gradients and metrics becomes their mean over dp."""

    def _global_sum(self, t):
        return t * self.mesh.dp


def _flat(tree, prefix):
    return {f"{prefix}/" + "/".join(k): np.asarray(v)
            for k, v in flatten_tree(tree).items()}


def _fresh_model():
    return build_model(CFG, init_params(CFG, seed=0))


def main(inp: str, out: str) -> None:
    torch.set_num_threads(1)
    device = init_from_env("cpu")
    mesh = make_mesh(4, dp=2, fsdp=2, device=device)
    data = np.load(inp)
    batches = [{k: data[f"{i}/{k}"] for k in KEYS} for i in range(2)]
    res = {}

    trainer = shard_train_step(mesh, CFG, TrainConfig(**TC), _fresh_model())
    for i, b in enumerate(batches):
        for k, v in trainer.step(shard_batch(mesh, b)).items():
            res[f"step{i}/{k}"] = np.float64(v)
    res.update(_flat(params_to_jax(trainer.model), "params"))
    mom = trainer.momentum()  # a collective: every rank calls it
    res.update({f"momentum/{n.replace('.', '/')}": v.numpy() for n, v in mom.items()})

    # every rank must hold rank 0's parameters and running statistics
    state = torch.cat([t.reshape(-1) for t in trainer.model.state_dict().values()])
    every = [torch.empty_like(state) for _ in range(mesh.size)]
    dist.all_gather(every, state)
    res["rank_param_diff"] = np.float64(max(float((e - every[0]).abs().max())
                                            for e in every))
    coords = torch.tensor([mesh.rank, *mesh.coords])
    every = [torch.empty_like(coords) for _ in range(mesh.size)]
    dist.all_gather(every, coords)
    res["coords"] = torch.stack(every).numpy()

    for name, cls in (("local_stats", LocalStatsTrainer),
                      ("local_norm", LocalNormTrainer)):
        t = cls(mesh, CFG, TrainConfig(**TC), _fresh_model())
        res[f"{name}/loss"] = np.float64(t.step(shard_batch(mesh, batches[0]))["loss"])

    model = fuse_for_inference(_fresh_model(), torch.float32)
    core = DetectCore(CFG, **DETECT)

    def detect(frames):
        with torch.inference_mode():
            return core(model, torch.as_tensor(frames))

    det = detect_dp(detect, mesh)(data["frames"])
    for f in det._fields:
        res[f"detect/{f}"] = getattr(det, f).numpy()
    if mesh.rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])

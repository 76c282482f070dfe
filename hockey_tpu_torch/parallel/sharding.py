"""Multi-device training and batched inference over a (dp, fsdp) mesh:
port of hockey_tpu/parallel/sharding.py.

- Batch tensors split their leading axis over dp (core/mesh.py
  `shard_batch`).
- Parameters FSDP-shard along the output channel: the JAX leaf's last
  axis, the port's dim 0 of `w` (OIHW), `b` and BN `scale`/`bias`,
  whenever it divides by fsdp and holds at least two channels per way
  (`param_pspec`). Each rank keeps the f32 master of its slice and the
  slice's momentum. The forward needs every channel, so after each update
  the slices are all-gathered into the model's full parameters; the
  memory saved is the momentum's and the masters', not the working copy's.
- `shard_train_step` builds the train step whose math is the single-device
  step's on the global batch, as GSPMD's is: BN batch statistics are the
  global batch's (sync-BN: each rank's statistics all-gathered over dp
  and combined in f64, the statistics' gradients all-reduced in the
  backward), the loss's normalisers are global sums, gradients are
  summed over dp (each rank's loss is its share of the global loss), and
  the clip, the non-finite skip and the metrics are the global batch's
  and rank 0's decision. The fsdp ranks of one dp row compute on the same rows and so
  hold the same gradient: the reduce-scatter over fsdp is each rank's
  slice of it, summed over dp.
- `detect_dp` splits a frame batch over dp and gathers the detections.

On a 1x1 mesh no collective runs and the step is `Trainer`'s, bit for
bit.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from ..core.mesh import FSDP_AXIS, Mesh, batch_sharding, gather_rows
from ..models.yolov8 import YoloConfig, params_to_jax
from ..train.trainer import Trainer, TrainConfig


def param_pspec(path, leaf, fsdp: int) -> Tuple:
    """The sharding of one parameter leaf, one entry per dim: FSDP_AXIS on
    the output channel (the port's dim 0) when it divides by fsdp and is
    at least 2 * fsdp, else () (replicated). `path` is unused, as in the
    JAX rule."""
    shape = tuple(getattr(leaf, "shape", ()))
    if fsdp > 1 and len(shape) >= 1 and shape[0] % fsdp == 0 \
            and shape[0] >= 2 * fsdp:
        return (FSDP_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def _shard_rows(mesh: Mesh, n: int) -> slice:
    per = n // mesh.fsdp
    f = mesh.coords[1]
    return slice(f * per, (f + 1) * per)


def shard_params(mesh: Mesh, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Each trainable parameter's f32 master on this rank, by name: its
    slice of the output channels (a copy) where `param_pspec` shards it,
    else the parameter itself."""
    out = {}
    for name, p in model.named_parameters():
        if param_pspec(name, p, mesh.fsdp):
            out[name] = p.detach()[_shard_rows(mesh, p.shape[0])].clone(
                memory_format=torch.contiguous_format)
        else:
            out[name] = p
    return out


def gather_params(trainer: "ShardedTrainer") -> Dict:
    """The whole parameter tree in the JAX msgpack layout (what
    models/checkpoint.py `save_params` writes). The step all-gathers the
    shards into the model after every update, so this needs no collective
    and one rank alone may call it."""
    return params_to_jax(trainer.model)


class _GlobalVarMean(torch.autograd.Function):
    """(biased variance, mean) per channel of the global batch whose rows
    are split evenly over `group`: each rank's torch.var_mean, all-gathered
    and combined in f64 (Chan's parallel rule: the mean of the means, the
    mean of var + (mean - global mean)^2), so no full-size pass is added
    to one device's. The backward all-reduces the statistics' gradients,
    the derivative of the sum of every rank's loss, and keeps only `y`
    and the mean."""

    @staticmethod
    def forward(ctx, y, group, ways):
        var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
        every = torch.empty((2 * ways, mean.numel()), dtype=mean.dtype,
                            device=mean.device)
        dist.all_gather_into_tensor(every, torch.stack([mean, var]), group=group)
        means, vars_ = every.double().view(ways, 2, -1).unbind(1)
        mean = means.mean(0)
        var = (vars_ + (means - mean) ** 2).mean(0)
        mean32 = mean.float()
        ctx.save_for_backward(y, mean32)
        ctx.group, ctx.n = group, y.shape[0] * y.shape[2] * y.shape[3] * ways
        return var.float(), mean32

    @staticmethod
    def backward(ctx, g_var, g_mean):
        y, mean = ctx.saved_tensors
        g = torch.stack([g_var, g_mean])
        dist.all_reduce(g, group=ctx.group)
        g_var, g_mean = g[0][:, None, None], g[1][:, None, None]
        return (g_mean + 2.0 * g_var * (y - mean[:, None, None])) / ctx.n, None, None


class SyncStats(list):
    """The train forward's stats list (models/layers.py) for a dp-sharded
    batch: `var_mean` gives each BN the global batch's statistics."""

    def __init__(self, group, ways: int):
        super().__init__()
        self.group, self.ways = group, ways

    def var_mean(self, y: torch.Tensor):
        return _GlobalVarMean.apply(y, self.group, self.ways)


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of a gradient-free tensor over `group` (itself without one)."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


class ShardedTrainer(Trainer):
    """`Trainer` over a mesh: `step(batch)` takes this rank's rows of the
    global batch (`shard_batch`) and returns the global batch's metrics,
    the same on every rank. The model holds the full parameters; the
    optimizer holds this rank's masters (`shard_params`) and their
    momentum. No EMA (the JAX CLI disables it under a mesh)."""

    def __init__(self, mesh: Mesh, cfg: YoloConfig, tc: TrainConfig,
                 model: torch.nn.Module):
        self.mesh = mesh
        super().__init__(cfg, tc, model)

    def _masters(self, named):
        self.specs = [param_pspec(n, p, self.mesh.fsdp) for n, p in named]
        masters = shard_params(self.mesh, self.model)
        return [(n, masters[n]) for n, _ in named]

    def _stats(self) -> List:
        g = self.mesh.dp_group
        return [] if g is None else SyncStats(g, self.mesh.dp)

    def _global_sum(self, t: torch.Tensor) -> torch.Tensor:
        return _sum_over(t, self.mesh.dp_group)

    def _grads(self) -> List[torch.Tensor]:
        """Each master's gradient: this rank's slice of the parameter's
        gradient where it is sharded, summed over dp in one all-reduce."""
        pieces = []
        for p, spec in zip(self.params, self.specs):
            g = p.grad
            if spec:
                g = g[_shard_rows(self.mesh, p.shape[0])]
            pieces.append(g)
        if self.mesh.dp_group is not None:
            flat = torch.cat([g.reshape(-1) for g in pieces])
            dist.all_reduce(flat, group=self.mesh.dp_group)
            pieces = [x.view(g.shape) for x, g in
                      zip(flat.split([g.numel() for g in pieces]), pieces)]
        for m, p, g, spec in zip(self.masters, self.params, pieces, self.specs):
            if spec:
                m.grad = g.clone(memory_format=torch.contiguous_format)
            elif g is not p.grad:
                p.grad.copy_(g)
        return [m.grad for m in self.masters]

    def _norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The whole gradient's norm: a sharded leaf's from its slices'
        squared norms summed over fsdp."""
        norms = list(torch._foreach_norm(grads))
        idx = [i for i, s in enumerate(self.specs) if s]
        if idx and self.mesh.fsdp_group is not None:
            sq = torch.stack([norms[i] for i in idx]) ** 2
            dist.all_reduce(sq, group=self.mesh.fsdp_group)
            for i, n in zip(idx, sq.sqrt()):
                norms[i] = n
        return torch.linalg.vector_norm(torch.stack(norms))

    def _decide(self, metrics: Dict, gn: torch.Tensor):
        """Metrics summed over dp; then rank 0's metrics, norm and decision
        on every rank, so that all ranks update or skip together."""
        keys = list(metrics)
        vec = _sum_over(torch.stack([metrics[k].detach().float() for k in keys]),
                        self.mesh.dp_group)
        metrics = dict(zip(keys, vec.unbind()))
        ok, small, gn, metrics = super()._decide(metrics, gn)
        if self.mesh.size > 1:
            vec = torch.cat([vec, torch.stack([gn.detach(), gn.new_tensor(float(ok)),
                                               gn.new_tensor(float(small))])])
            dist.broadcast(vec, 0)
            metrics = dict(zip(keys, vec[:len(keys)].unbind()))
            gn, ok, small = vec[-3], bool(vec[-2]), bool(vec[-1])
        return ok, small, gn, metrics

    def _updated(self) -> None:
        """All-gather the updated slices over fsdp into the model's full
        parameters, in one collective."""
        idx = [i for i, s in enumerate(self.specs) if s]
        if not idx:
            return
        f = self.mesh.fsdp
        shards = [self.masters[i].detach() for i in idx]
        flat = torch.cat([s.reshape(-1) for s in shards])
        out = torch.empty(f * flat.numel(), dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=self.mesh.fsdp_group)
        out = out.view(f, -1)
        off = 0
        with torch.no_grad():
            for i, s in zip(idx, shards):
                n = s.numel()
                self.params[i].copy_(
                    out[:, off:off + n].reshape(f * s.shape[0], *s.shape[1:]))
                off += n

    def momentum(self) -> Dict[str, torch.Tensor]:
        """The whole SGD momentum by parameter name (sharded slices
        all-gathered: every rank must call it), empty before the first
        update."""
        out = {}
        for (name, _), m, spec in zip(self.named, self.masters, self.specs):
            buf = self.opt.state.get(m, {}).get("momentum_buffer")
            if buf is None:
                continue
            if spec:
                full = torch.empty((self.mesh.fsdp * buf.shape[0], *buf.shape[1:]),
                                   dtype=buf.dtype, device=buf.device)
                dist.all_gather_into_tensor(full, buf.contiguous(),
                                            group=self.mesh.fsdp_group)
                buf = full
            out[name] = buf
        return out


def shard_train_step(mesh: Mesh, cfg: YoloConfig, tc: TrainConfig,
                     model: torch.nn.Module) -> ShardedTrainer:
    """The counterpart of `jit_train_step`: a trainer of `model` (the same
    full weights on every rank, turned into the training form in place)
    over `mesh`, whose step on each rank's rows of a global batch equals
    the single-device `Trainer` step on that batch."""
    return ShardedTrainer(mesh, cfg, tc, model)


def _gather_out(mesh: Mesh, out):
    if isinstance(out, torch.Tensor):
        return gather_rows(mesh, out)
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(_gather_out(mesh, x) for x in out))
    if isinstance(out, tuple):
        return tuple(_gather_out(mesh, x) for x in out)
    return out


def detect_dp(detect_fn: Callable, mesh: Mesh) -> Callable:
    """The counterpart of `jit_detect_dp`: fn(frames) runs `detect_fn`
    (e.g. `Detector.detect_batch`: frames (B, H, W, 3) uint8 -> padded
    Detections, or a tuple of them and per-frame tensors) on this rank's
    dp rows of the global frame batch and returns every output tensor
    gathered over dp in frame order, on every rank."""
    def fn(frames):
        return _gather_out(mesh, detect_fn(frames[batch_sharding(mesh, len(frames))]))

    return fn


"""The (dp, fsdp) device mesh over a torch.distributed process group, and
the launcher that starts one process per device. Port of
hockey_tpu/core/mesh.py.

Axes, as in the JAX package:

- ``dp``   — data parallel (frame batch / training batch dimension);
- ``fsdp`` — parameter sharding (output-channel dim of conv kernels).

Rank r sits at (r // fsdp, r % fsdp), the JAX mesh's row-major reshape of
its device list. The batch's leading axis splits over dp, so the fsdp
ranks of one dp row hold the same rows. The process group is NCCL on CUDA
and gloo on the CPU; one process drives one device. A 1x1 mesh needs no
collective and computes what the unsharded step computes.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DP_AXIS = "dp"
FSDP_AXIS = "fsdp"


def mesh_layout(dp: int, fsdp: int) -> Tuple[List[List[int]], List[List[int]]]:
    """(dp groups, fsdp groups) as rank lists: dp group f holds the ranks
    of fsdp coordinate f (they split the batch), fsdp group d the ranks of
    dp row d (they split the parameters)."""
    dp_groups = [[d * fsdp + f for d in range(dp)] for f in range(fsdp)]
    fsdp_groups = [[d * fsdp + f for f in range(fsdp)] for d in range(dp)]
    return dp_groups, fsdp_groups


@dataclasses.dataclass
class Mesh:
    """This process's place in a (dp, fsdp) mesh: its rank, coordinates,
    device and the process groups of its dp column and fsdp row (None
    where that axis has one way, so no collective runs)."""

    dp: int
    fsdp: int
    rank: int
    device: torch.device
    dp_group: Optional[object] = None
    fsdp_group: Optional[object] = None

    @property
    def shape(self):
        return {DP_AXIS: self.dp, FSDP_AXIS: self.fsdp}

    @property
    def size(self) -> int:
        return self.dp * self.fsdp

    @property
    def coords(self) -> Tuple[int, int]:
        """(dp index, fsdp index) of this rank."""
        return divmod(self.rank, self.fsdp)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              fsdp: int = 1, device=None) -> Mesh:
    """Build a (dp, fsdp) mesh over the initialised process group (a 1x1
    mesh needs none). Every rank must call it, with the same arguments.
    `device` defaults to cuda:<local rank> when CUDA is available, else
    the CPU."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if dp is None:
        dp = n_devices // fsdp
    if dp * fsdp != n_devices:
        raise ValueError(f"dp({dp}) * fsdp({fsdp}) != n_devices({n_devices})")
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs as many "
                         f"processes; the process group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    mesh = Mesh(dp, fsdp, rank, torch.device(device))
    dp_groups, fsdp_groups = mesh_layout(dp, fsdp)
    d, f = mesh.coords
    # new_group is collective: every rank creates every group, in one order
    for i, ranks in enumerate(dp_groups):
        g = dist.new_group(ranks) if dp > 1 else None
        if i == f:
            mesh.dp_group = g
    for i, ranks in enumerate(fsdp_groups):
        g = dist.new_group(ranks) if fsdp > 1 else None
        if i == d:
            mesh.fsdp_group = g
    return mesh


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of `n`: its dp coordinate's
    contiguous n / dp rows (the fsdp ranks of one dp row share them)."""
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} does not split over dp={mesh.dp}")
    per = n // mesh.dp
    d = mesh.coords[0]
    return slice(d * per, (d + 1) * per)


def shard_batch(mesh: Mesh, tree):
    """A dict (or one array) of numpy arrays or tensors with its leading
    axis cut to this rank's rows, as tensors on the mesh's device."""
    def put(x):
        return torch.as_tensor(x[batch_sharding(mesh, len(x))]).to(mesh.device)

    if isinstance(tree, dict):
        return {k: put(v) for k, v in tree.items()}
    return put(tree)


# --------------------------------------------------------------------------
# process groups and the launcher

def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launched() -> bool:
    """Whether this process was started by `launch` or torchrun."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device_type: str) -> torch.device:
    """Join the process group that `launch` or torchrun set up in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):
    NCCL on CUDA, gloo on the CPU. Returns this process's device."""
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        device = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return device


def launch(argv: Sequence[str], world: int, device_type: str,
           timeout: Optional[float] = None) -> int:
    """Run `python *argv` in `world` processes, rank r on device r (CUDA)
    or the CPU, joined through a free localhost port (on the CPU
    OMP_NUM_THREADS, unless set, is the cores over `world`). A rank that
    fails stops the others, as does `timeout` (seconds; then the return
    code is 124). Returns 0, or the return code of the first rank seen
    failing."""
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base = dict(os.environ)
    base["PYTHONPATH"] = os.pathsep.join(
        [root] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
    if device_type == "cpu":
        base.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    procs = []
    for r in range(world):
        rank_env = dict(base, RANK=str(r), LOCAL_RANK=str(r),
                        WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                        MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, *argv], env=rank_env))
    deadline = None if timeout is None else time.monotonic() + timeout
    timed_out = False
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs) or any(rc for rc in rcs):
                break
            if deadline is not None and time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if timed_out:
        return 124
    bad = [rc for rc in rcs if rc]  # the ranks that ended on their own
    if not bad:
        return 0
    return bad[0] if bad[0] > 0 else 128 - bad[0]  # a signal: 128 + its number


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The dp column's rows of `x` (each rank's from `shard_batch`),
    concatenated in rank order: the global batch's rows on every rank."""
    if mesh.dp_group is None:
        return x
    x = x.contiguous()
    out = torch.empty((mesh.dp * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.dp_group)
    return out


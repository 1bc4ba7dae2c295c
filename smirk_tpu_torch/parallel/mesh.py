"""Data-parallel training over torch.distributed (port of
smirk_tpu/parallel/mesh.py).

The contract is the JAX package's: a step on W processes, each holding its
contiguous rows [r*b, (r+1)*b) of a global batch of W*b, computes the
one-process step on the whole global batch. XLA's sharding gives the JAX
package that for free; in eager PyTorch the step asks for it at each place
where rows meet (`train.trainer`, `models.mobilenetv3.BatchNorm2d`):

  * every loss term is this rank's share of the global one (`share`: a
    mean over rows is the local mean over W; the masked landmark loss
    divides by the global count of labelled rows, `all_sum`);
  * the gradients are summed across ranks, one flattened all-reduce per
    backward (`all_reduce_grads`): `torch.autograd.grad` runs no
    `AccumulateGrad` hook, so DistributedDataParallel's reducer never
    fires;
  * train-mode batch norm normalizes with the global batch's statistics
    (`global_moments`, autograd-aware, as nn.SyncBatchNorm does);
  * every rank draws the global batch's draws from the step's generator
    and keeps its own rows (`local_rows`); the cycle path's parameter
    augmentation permutes rows across the global batch, so it runs on the
    gathered rows (`all_gather_rows`);
  * the metrics are reduced in one collective (`reduce_metrics`).

With no process group nothing here issues a collective and the one-process
step is what it was. One process drives one device: `cuda:LOCAL_RANK`
with NCCL, or the CPU with gloo when the caller asks for it. Every
collective of a step can be recorded (`record`) so that a measurement can
replay them alone.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

# the collectives of the running code, when a list: (name, elements, dtype)
_record: Optional[List[tuple]] = None


def initialize_distributed(device: Optional[str] = None) -> int:
    """Join the process group that torch's launcher describes (`torchrun`
    sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT) ->
    the world size. NCCL on the card (this process's card is cuda:
    LOCAL_RANK, made current), gloo when `device` is "cpu". Without
    WORLD_SIZE in the environment: 1, no group and no collective. An
    initialized group is kept."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 1
    missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {', '.join(missing)} are not; a "
                           "data-parallel run needs all of RANK, WORLD_SIZE, MASTER_ADDR "
                           "and MASTER_PORT (torchrun sets them)")
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(process_device(device))
    dist.init_process_group(
        "gloo" if cpu else "nccl",
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_world_size()


def process_device(device: Optional[str] = None) -> torch.device:
    """This process's device: `device` when given, else cuda:LOCAL_RANK."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def active() -> bool:
    """Whether a process group is initialized (a data-parallel step)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    """Rank 0, or no group: the process that logs and writes files."""
    return rank() == 0


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


@contextlib.contextmanager
def record():
    """Within the block every collective of this module appends (name,
    elements, dtype) to the yielded list."""
    global _record
    saved, _record = _record, []
    try:
        yield _record
    finally:
        _record = saved


def _note(name: str, t: torch.Tensor) -> None:
    if _record is not None:
        _record.append((name, t.numel(), t.dtype))


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A tensor the group's backend takes: gloo gets CUDA tensors through a
    host copy (two gloo ranks may share one card)."""
    if t.is_cuda and dist.get_backend() == dist.Backend.GLOO:
        return t.cpu()
    return t


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` across ranks in place -> t."""
    _note("all_reduce", t)
    s = _staged(t)
    dist.all_reduce(s)
    if s is not t:
        t.copy_(s)
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks with its gradient: the backward sums the output's
    gradient across ranks (torch.distributed.nn.functional.all_reduce,
    with each collective recorded)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(memory_format=torch.contiguous_format))


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks (no gradient); `t` without a group."""
    return _all_reduce_(t.detach().clone()) if active() else t


def share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a mean over the global batch's rows, from the
    mean over its own rows (every rank holds as many): x / W; x without a
    group."""
    return x / world_size() if active() else x


def global_moments(x: torch.Tensor):
    """Batch norm's statistics of the global batch: per channel (dim 1)
    mean and biased variance over every rank's (N, C, H, W) rows ->
    (mean, var), differentiable. Each rank's local mean and variance
    (`torch.var_mean`, two-pass) and its count go into its row of a (W,
    2C+1) table that one autograd-aware all-reduce fills; Chan's
    combination of the rows then gives the global moments without the
    cancellation of E[x^2] - E[x]^2, identically on every rank."""
    C = x.shape[1]
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    n = x.new_full((1,), x.numel() // C)
    W, r = world_size(), rank()
    rows = [x.new_zeros(2 * C + 1)] * W
    rows[r] = torch.cat([mean, var, n])
    table = _AllReduceSum.apply(torch.stack(rows))
    means, vars_, counts = table[:, :C], table[:, C:2 * C], table[:, 2 * C:]
    w = counts / counts.sum()
    g_mean = (w * means).sum(0)
    g_var = (w * (vars_ + (means - g_mean) ** 2)).sum(0)
    return g_mean, g_var


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients summed across ranks, in one flattened all-reduce;
    the list as it is without a group."""
    grads = list(grads)
    if not active() or not grads:
        return grads
    flat = _all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def all_gather_rows(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every rank's rows of each (b, ...) tensor, in rank order ->
    {name: (W*b, ...)}, in one all-gather of the flattened rows (no
    gradient)."""
    names = list(tensors)
    b = tensors[names[0]].shape[0]
    flat = torch.cat([tensors[k].detach().reshape(b, -1).to(torch.float32)
                      for k in names], dim=1)
    _note("all_gather", flat)
    s = _staged(flat)
    parts = [torch.empty_like(s) for _ in range(world_size())]
    dist.all_gather(parts, s)
    full = torch.cat(parts).to(flat.device)
    out, at = {}, 0
    for k in names:
        t = tensors[k]
        width = t[0].numel()
        out[k] = full[:, at:at + width].reshape((-1,) + tuple(t.shape[1:])).to(t.dtype)
        at += width
    return out


def local_rows(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """This rank's rows of a global tensor of `groups` stacked copies of
    the global batch (groups x W x b rows, group-major, as torch.cat([x] *
    groups) stacks them) -> (groups * b, ...); x without a group."""
    if not active():
        return x
    W = world_size()
    b = x.shape[0] // (groups * W)
    return x.reshape((groups, W, b) + tuple(x.shape[1:]))[:, rank()].reshape(
        (groups * b,) + tuple(x.shape[1:]))


def reduce_metrics(values: torch.Tensor, is_max: Sequence[bool]) -> torch.Tensor:
    """The metric vector of the global batch from each rank's: one
    all-gather, then the sum over ranks of each share and the max of each
    entry flagged in `is_max` (per-image maxima); `values` without a
    group."""
    if not active():
        return values
    table = all_gather_rows({"v": values[None]})["v"]  # (W, K)
    mask = torch.tensor(list(is_max), device=values.device)
    return torch.where(mask, table.amax(0), table.sum(0))


def shard_batch(batch: Mapping[str, torch.Tensor]) -> Optional[Dict[str, torch.Tensor]]:
    """This rank's contiguous rows [r*b, (r+1)*b) of a global batch that
    every rank holds (b = rows / W); None for a ragged batch whose rows W
    does not divide (skipped, as the JAX package skips it); the batch
    itself without a group."""
    if not active():
        return dict(batch)
    W, r = world_size(), rank()
    n = int(next(iter(batch.values())).shape[0])
    if n % W:
        return None
    b = n // W
    return {k: v[r * b:(r + 1) * b] for k, v in batch.items()}


def replicate(system) -> None:
    """Broadcast rank 0's training state to every rank, in place: the
    encoder's, the base encoder's and the generator's parameters and
    buffers, both optimizers' Adam state and the step counter (after a
    resume, so that every rank starts from the same state)."""
    if not active():
        return
    tensors = []
    for m in (system.encoder, system.base_encoder, system.generator):
        if m is not None:
            tensors += list(m.parameters()) + list(m.buffers())
    for opt in (system.enc_opt, system.gen_opt):
        if opt is not None:
            for p in opt.param_groups[0]["params"]:
                tensors += [t for _, t in sorted(opt.state.get(p, {}).items())
                            if torch.is_tensor(t)]
    step = torch.tensor([system.step], dtype=torch.int64)
    with torch.no_grad():
        for t in tensors + [step]:
            s = _staged(t.data)
            if s.device.type == "cpu" and dist.get_backend() != dist.Backend.GLOO:
                s = s.to(process_device())
            _note("broadcast", s)
            dist.broadcast(s, 0)
            if s is not t.data:
                t.data.copy_(s)
    system.step = int(step)

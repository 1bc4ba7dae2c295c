"""`dryrun_multichip(n)`: the data-parallel step on n gloo processes on
the CPU (the twin of `dryrun_multichip` in __graft_entry__.py).

    python -m smirk_tpu_torch.parallel.dryrun N

Spawns N processes that join one gloo group on a free local port and run
that function's tiny configuration (32 px, 10 expression / 30 shape components,
the generator at 8 features / 1 ResNet block, no teachers) on a global
batch of N seeded rows, one a process: one training step of each parity,
every metric finite and every rank's parameters equal after each step.
Prints `dryrun_multichip(N) ok: {...}` with the global metrics (rank 0's).
The FLAME assets are the asset root's when there is one, else the
procedural head.
"""
from __future__ import annotations

import math
import os
import socket
import sys

import numpy as np
import torch

S = 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bundle():
    from smirk_tpu_torch import assets

    try:
        return assets.load_all()
    except FileNotFoundError:
        return assets.procedural_bundle(seed=0, full_size=False)


def _batch(n: int):
    rng = np.random.default_rng(0)
    return {
        "img": rng.random((n, S, S, 3)).astype(np.float32),
        "landmarks_fan": rng.uniform(-1, 1, (n, 68, 2)).astype(np.float32),
        "flag_landmarks_fan": np.ones((n,), bool),
        "landmarks_mp": rng.uniform(-1, 1, (n, 105, 2)).astype(np.float32),
        "mask": (rng.random((n, S, S, 1)) > 0.5).astype(np.float32),
        "img_mica": np.zeros((n, 112, 112, 3), np.float32),
    }


def _params_equal_across_ranks(system) -> bool:
    from smirk_tpu_torch import parallel

    mine = torch.cat([p.detach().reshape(-1) for p in system.enc_params + system.gen_params])
    gathered = parallel.all_gather_rows({"p": mine[None]})["p"]
    return bool((gathered == mine[None]).all())


def _rank_main(rank: int, n: int, port: int, results) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from smirk_tpu_torch import parallel
    from smirk_tpu_torch.config import ArchConfig, Config, LossWeights, TrainConfig
    from smirk_tpu_torch.train.trainer import SmirkSystem

    assert parallel.initialize_distributed("cpu") == n
    try:
        cfg = Config(image_size=S, arch=ArchConfig(num_expression=10, num_shape=30),
                     train=TrainConfig(batch_size=n, mask_ratio=0.02, mask_dilation_radius=3,
                                       loss_weights=LossWeights(perceptual_vgg_loss=0.0,
                                                                emotion_loss=0.0,
                                                                mica_loss=0.0)))
        system = SmirkSystem(cfg, _bundle(), device="cpu", steps_per_epoch=10,
                             generator_features=8, generator_res_blocks=1)
        batch = parallel.shard_batch({k: torch.from_numpy(v) for k, v in _batch(n).items()})
        metrics = {}
        for parity in (0, 1):
            m, _ = system.train_step(batch, parity=parity)
            assert system.step == parity + 1
            key = "loss_first_path" if parity == 0 else "loss_second_path"
            assert math.isfinite(m[key]), (parity, m)
            assert _params_equal_across_ranks(system), f"ranks' parameters differ (p{parity})"
            metrics.update({f"p{parity}/{k}": v for k, v in m.items()})
        if rank == 0:
            results.put(metrics)
    finally:
        parallel.shutdown()


def dryrun_multichip(n: int, timeout: float = 600.0) -> None:
    """One step of each parity on n gloo processes (see the module)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, results)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        metrics = results.get(timeout=timeout)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n}): ranks {failed} failed")
    print(f"dryrun_multichip({n}) ok:", metrics, flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)

"""Restart-based recovery supervisor for the port's training CLI (the twin
of tools/train_supervisor.py).

  python -m smirk_tpu_torch.cli.train_supervisor [--max-restarts N]
      [--backoff SEC] [--no-probe] <smirk_tpu_torch.cli.train args...>

Runs `python -m smirk_tpu_torch.cli.train` as a child process; on a
nonzero exit it relaunches with `resume_state=<log_path>/last_state.pt`
(the full training state the CLI writes every `train.ckpt_every_steps`
steps, at every epoch end, and on a crash after a completed step), with
bounded retries and a backoff. A user's own resume_state= is honoured
and never overridden. Before the first launch and after each failure a
probe (a matmul on the card, in a subprocess) waits for the card to
answer; --no-probe skips it (a CPU run).

Unlike the JAX package's supervisor, the relaunch does not escalate to
SMIRK_STEP_MODE=split: that picks how many jitted programs the JAX package
compiles, and the port's eager step reads `train.step_mode` nowhere.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

_PROBE = ("import torch\n"
          "x = torch.ones((256, 256), device='cuda')\n"
          "print('probe ok', float((x @ x).sum()))\n")


def _extract_log_path(args) -> str:
    """The child's log path as the CLI resolves it: a dotted override first,
    else the YAML config's train.log_path, else the default (watching the
    wrong path would mean cold restarts that lose progress)."""
    for a in args:
        if a.startswith("train.log_path="):
            return a.split("=", 1)[1]
    yamls = [a for a in args if a.endswith((".yaml", ".yml"))]
    if yamls:
        try:
            from smirk_tpu_torch.config import load_config

            return load_config(yamls[0]).train.log_path
        except Exception as e:  # noqa: BLE001 -- the child will report it
            print(f"[supervisor] could not read {yamls[0]}: {e}", flush=True)
    from smirk_tpu_torch.config import Config

    return Config().train.log_path


def wait_device_healthy(env=None, attempts: int = 12, probe_timeout: float = 240.0,
                        sleep_s: float = 120.0) -> bool:
    """Block until a matmul on the card runs in a fresh process."""
    for i in range(attempts):
        try:
            r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                               timeout=probe_timeout, capture_output=True)
            if r.returncode == 0:
                return True
        except subprocess.TimeoutExpired:
            pass
        print(f"[supervisor] device probe {i} failed; retry in {sleep_s:.0f}s", flush=True)
        time.sleep(sleep_s)
    return False


def supervise(cmd, log_path: str, max_restarts: int = 10, backoff: float = 120.0,
              env=None, probe: bool = False) -> int:
    """Run `cmd` (argv list); relaunch with resume_state on failure ->
    the final exit code (0 on eventual success)."""
    resume = os.path.join(log_path, "last_state.pt")
    if probe and not wait_device_healthy(env):
        print("[supervisor] device not healthy at launch; aborting", flush=True)
        return 1
    attempt = 0
    while True:
        argv = list(cmd)
        # resume whenever a checkpoint exists (also on the first attempt: a
        # relaunched supervisor must be idempotent); a user's resume_state=
        # is a deliberate rollback and is never overridden (overrides apply
        # in argv order, so appending ours would win)
        if any(str(a).startswith("resume_state=") for a in argv):
            if attempt == 0:
                print("[supervisor] honoring user resume_state (auto-resume from "
                      "last_state.pt disabled for this run)", flush=True)
        elif os.path.exists(resume):
            argv.append(f"resume_state={resume}")
        print(f"[supervisor] launch attempt {attempt}: {' '.join(map(str, argv[-3:]))}",
              flush=True)
        rc = subprocess.call(argv, env=env)
        if rc == 0:
            print("[supervisor] training completed", flush=True)
            return 0
        attempt += 1
        if attempt > max_restarts:
            print(f"[supervisor] giving up after {max_restarts} restarts (last rc={rc})",
                  flush=True)
            return rc
        has_ckpt = os.path.exists(resume)
        print(f"[supervisor] child failed rc={rc}; "
              f"{'resuming from ' + resume if has_ckpt else 'no checkpoint; cold restart'}"
              f" in {backoff:.0f}s", flush=True)
        time.sleep(backoff)
        if probe and not wait_device_healthy(env):
            print("[supervisor] device never became healthy; giving up", flush=True)
            return rc


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    max_restarts, backoff, probe = 10, 120.0, True
    if "--max-restarts" in argv:
        i = argv.index("--max-restarts")
        max_restarts = int(argv[i + 1])
        del argv[i:i + 2]
    if "--backoff" in argv:
        i = argv.index("--backoff")
        backoff = float(argv[i + 1])
        del argv[i:i + 2]
    if "--no-probe" in argv:
        probe = False
        argv.remove("--no-probe")
    cmd = [sys.executable, "-m", "smirk_tpu_torch.cli.train"] + argv
    sys.exit(supervise(cmd, _extract_log_path(argv), max_restarts, backoff, probe=probe))


if __name__ == "__main__":
    main()

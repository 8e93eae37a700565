"""Preemption-safe training: checkpoint-on-signal + auto-requeue.

Counterpart of hotformerloc_tpu/training/elastic.py: on SLURM
timeout/preemption (SIGTERM/SIGUSR1) the epoch loop finishes the
current epoch, dumps a full `_latest.ckpt`, and exits with
REQUEUE_EXIT_CODE; `run_elastic` (or a SLURM `--requeue` array) then
relaunches the same command with `--resume_from` pointing at that
checkpoint, up to `max_requeues` times. Recovery granularity is the
epoch.

Usage (library):
    trainer = Trainer(params)
    install_preemption_handler(trainer)
    trainer.train()

Usage (launcher):
    python -m hotformerloc_torch.training.elastic --max_requeues 5 -- \
        python -m hotformerloc_torch.training.train --config ... \
        --model_config ...
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Iterable

REQUEUE_EXIT_CODE = 99
_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)


def install_preemption_handler(trainer,
                               signals: Iterable[int] = _DEFAULT_SIGNALS):
    """Arm `trainer` to checkpoint and stop at the next epoch boundary
    when a preemption signal arrives. Returns the trainer."""
    def _handler(signum, frame):
        print(f"[elastic] caught signal {signum}; will checkpoint and "
              f"requeue at the next epoch boundary", flush=True)
        trainer.preempted = True

    for s in signals:
        signal.signal(s, _handler)
    return trainer


def maybe_requeue_exit(trainer, epoch: int):
    """Called by the trainer after each epoch: if a preemption signal
    was seen, save the resumable checkpoint and exit with the requeue
    code. Over a process group every rank calls it (the trainer agrees
    on the flag first); rank 0 writes the checkpoint and every rank
    waits for it before exiting, so the requeue resumes all ranks from
    it."""
    if not getattr(trainer, "preempted", False):
        return
    path = trainer.save("latest", epoch)
    from hotformerloc_torch.parallel.dist import barrier
    barrier(getattr(trainer, "group", None))
    print(f"[elastic] checkpoint saved to {path}; exiting for requeue",
          flush=True)
    sys.exit(REQUEUE_EXIT_CODE)


def run_elastic(cmd, max_requeues: int = 5, resume_arg: str = "--resume_from",
                ckpt_path: str | None = None) -> int:
    """Run `cmd` (a list), relaunching on REQUEUE_EXIT_CODE.

    On each requeue, `resume_arg <ckpt>` is appended (once) so the
    child resumes from the latest checkpoint. Gives up after
    `max_requeues` preemptions.
    """
    attempt = 0
    while True:
        full = list(cmd)
        if attempt > 0 and ckpt_path and resume_arg not in cmd:
            full += [resume_arg, ckpt_path]
        print(f"[elastic] launch attempt {attempt}: {' '.join(full)}",
              flush=True)
        rc = subprocess.call(full)
        if rc != REQUEUE_EXIT_CODE:
            return rc
        attempt += 1
        if attempt > max_requeues:
            print(f"[elastic] exceeded {max_requeues} requeues; giving up",
                  flush=True)
            return rc
        time.sleep(1.0)


def inject_fault(pid: int | None = None, delay_s: float = 0.0,
                 sig: int = signal.SIGUSR1):
    """Fault-injection hook for testing the preemption path. Sends `sig`
    to `pid` (default: this process) after `delay_s`."""
    if delay_s > 0:
        time.sleep(delay_s)
    os.kill(pid or os.getpid(), sig)


def main():
    ap = argparse.ArgumentParser(
        description="Elastic launcher: requeue training on preemption")
    ap.add_argument("--max_requeues", type=int, default=5)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint passed via --resume_from on requeue")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- <training command>")
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (use: ... -- python -m ...)")
    sys.exit(run_elastic(cmd, args.max_requeues, ckpt_path=args.ckpt))


if __name__ == "__main__":
    main()

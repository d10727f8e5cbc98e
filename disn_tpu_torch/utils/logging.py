"""Logging, timers and profiling (port of disn_tpu/utils/logging.py).

MetricLogger writes three sinks: stdout, a flushed text log
(log_<name>.txt) and a machine-readable metrics_<name>.jsonl. Timer keeps
per-phase wall-clock EMAs. trace() records a torch.profiler trace of the
block and writes it as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Iterator

import torch


class MetricLogger:
    def __init__(self, log_dir: str | None = None, name: str = "train",
                 stdout: bool = True):
        self.stdout = stdout
        self.txt = None
        self.jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.txt = open(os.path.join(log_dir, f"log_{name}.txt"), "a")
            self.jsonl = open(os.path.join(log_dir, f"metrics_{name}.jsonl"),
                              "a")

    def log(self, msg: str) -> None:
        if self.stdout:
            print(msg, flush=True)
        if self.txt:
            self.txt.write(msg + "\n")
            self.txt.flush()

    def metrics(self, step: int, values: dict[str, Any], **extra) -> None:
        """One record; 0-d tensors are read here (a device sync)."""
        rec = {"step": int(step), "time": time.time(), **extra}
        for k, v in values.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self.jsonl:
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        pretty = " ".join(f"{k}={rec[k]:.6g}" for k in values if k in rec
                          and isinstance(rec[k], float))
        self.log(f"step {step}: {pretty}")

    def close(self) -> None:
        for f in (self.txt, self.jsonl):
            if f:
                f.close()


class Timer:
    """Named phase timers with exponential moving averages (host clock:
    a phase that only queues device work measures the queueing)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.avg[name] = (self.avg.get(name, dt) * self.ema
                          + dt * (1 - self.ema))

    def summary(self) -> str:
        return " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in self.avg.items())


@contextlib.contextmanager
def trace(log_dir: str | None) -> Iterator[Any]:
    """torch.profiler over the block (CPU ops, and the card's kernels when
    there is one), written to `<log_dir>/trace.json` as a Chrome trace;
    yields the profiler. A no-op that yields None when log_dir is None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def progress(i: int, n: int, every: int = 50) -> bool:
    return i % every == 0 or i == n - 1

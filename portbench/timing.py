"""Card, percentile and profiler helpers of the harness (the card label as
the program's probes print it: nvidia-smi's name and power limit)."""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np


def card_label(index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    'not read' where nvidia-smi cannot say."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        return out[index]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'not read'


def p95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


@contextlib.contextmanager
def profiled(span: str):
    """torch.profiler over the block (CPU and, on the card, CUDA
    activities) with the host span `span` around it; yields the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(span):
            yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class Phases:
    """The seconds of set-up's phases, each from the end of the one before
    (the first from `t0`, the process's start)."""

    def __init__(self, t0: float):
        self.t0 = self.at = t0
        self.seconds = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.at
        self.at = now

    def total(self) -> float:
        return time.perf_counter() - self.t0

    def line(self) -> str:
        return 'setup: ' + ', '.join(f'{k} {v:.3f} s'
                                     for k, v in self.seconds.items())

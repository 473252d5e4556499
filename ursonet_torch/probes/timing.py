"""Timing and labelling shared by the probe entry points."""

from __future__ import annotations

import json
import math
import subprocess
import time

import torch


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; 'cpu'
    for the CPU."""
    if device.type != 'cuda':
        return 'cpu'
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[device.index or 0]


def time_ms(fn, reps: int, device: torch.device, warmup: int = 1) -> float:
    """Mean time of fn() in ms over `reps` calls after `warmup`: CUDA
    events around the queued calls on the card, the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def sm_clock_mhz(fn, ms: float, device: torch.device,
                 busy_ms: float = 300.0):
    """The SM clock in MHz as nvidia-smi reads it while the card runs
    fn(): calls for about `busy_ms` of work (`ms` each) are queued, the
    clock is read, then the queue drains. None on the CPU."""
    if device.type != 'cuda':
        return None
    for _ in range(min(2000, max(1, math.ceil(busy_ms / max(ms, 1e-3))))):
        fn()
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm', '--format=csv,noheader,nounits',
         '-i', str(device.index or 0)], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    torch.cuda.synchronize(device)
    return float(out)


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time of one fn() call, apart from the host's pace: n calls
    captured in a CUDA graph (after 2 warm-up calls on a side stream),
    the graph replayed `reps` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * n)
    del graph
    torch.cuda.empty_cache()
    return ms


def record(results: list, **row) -> dict:
    """Print one JSON line and keep the row."""
    print(json.dumps(row), flush=True)
    results.append(row)
    return row

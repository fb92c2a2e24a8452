"""Device time of calls on one CUDA card, for the kernel checks and
``chip_smoke.py``.

:func:`cuda_time_ms` times calls launched back to back between two CUDA
events: it reads the device only while each call's device work outlasts the
host work of issuing the next one.  :func:`graph_time_ms` captures the calls
in a CUDA graph once and replays it, so no host work sits between the
launches and the time is the device's.
"""

from __future__ import annotations

import torch


def cuda_time_ms(fn, reps: int) -> float:
    """Mean time of ``fn(i)`` over ``reps`` calls (i = 0 ..) issued back to
    back, after 3 warm-up calls, between CUDA events."""
    for i in range(3):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn(i)`` for i < ``reps``, captured once in a
    CUDA graph (after 3 warm-up calls on a side stream) and replayed 3
    times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)

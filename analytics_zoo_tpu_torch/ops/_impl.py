"""Kernel-vs-plain resolution for every op that holds a hand-written kernel.

The counterpart of the JAX package's ``quant_matmul._resolve_impl``, with
the port's rule: the kernel is taken for CUDA tensors and the plain PyTorch
version for CPU tensors — and for no other reason.  A CUDA tensor under
``auto`` launches the kernel or raises; it never falls back.  An explicit
``impl="torch"`` runs the plain version anywhere (the parity tests and
``chip_smoke.py`` hold the kernel against it on the card).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Optional

import torch

IMPLS = ("auto", "torch", "cuda")

# streaming multiprocessors of the H100 SXM: the rules that size a launch
# (paged partitions, the conv's split of K) take this where no card is
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """``"cuda"`` (launch the kernel) or ``"torch"`` (plain version) for an
    op whose leading operand is ``x``."""
    impl = impl or "auto"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "torch":
        return "torch"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors, got a tensor on "
                         f"{x.device}")
    return "cuda" if x.is_cuda else "torch"


def launched() -> int:
    """What a wrapper adds to its launch counter where it launches its
    kernel: 1, or 0 while the calling thread's stream is capturing a CUDA
    graph (the call records the launch into the graph and runs nothing).
    So a counter holds the launches issued eagerly; a graph's replays are
    counted on the card (``card_launches``)."""
    capturing = (torch.cuda.is_available()
                 and torch.cuda.is_current_stream_capturing())
    return 0 if capturing else 1


# each hand-written kernel's entry point as the card's trace names it
# (a substring of the demangled name)
KERNEL_NAMES = {"paged": "paged_attention_kernel",
                "flash_fwd": "flash_fwd_kernel",
                "w8a8": "w8a8_kernel",
                "w4a16": "w4a16_kernel",
                "w8a8_conv": "w8a8_conv2d_kernel"}


# The profiler records one session a process.  Whoever records holds this
# lock for the session: ``card_launches`` waits for it,
# ``ClusterServing.start_profile`` refuses while it is held.
PROFILER_LOCK = threading.Lock()

# the profiler's warm-up before the counted block: launches and a wait
WARMUP_LAUNCHES = 64
WARMUP_S = 0.1
# the wait after the trace starts recording, before the block, and after
# the block's work has ended, before the trace stops
SETTLE_S = 0.2


@contextlib.contextmanager
def card_launches(kernels=tuple(KERNEL_NAMES)):
    """Count the launches the card runs inside the block, by kernel:
    the kernel records of a ``torch.profiler`` trace of the device
    (``ProfilerActivity.CUDA``), whatever issued them: a wrapper, or the
    replay of a CUDA graph that a wrapper was captured into.  Yields a
    dict ``{kernel: launches}`` over ``kernels`` (keys of
    ``KERNEL_NAMES``), filled when the block ends; without a CUDA device
    nothing runs on a card and every count stays 0.

    A trace started and recording at once can lose the records of its
    first kernels: on the H100 traces lacked their first 8 kernel records
    (and once a decode replay's 12), though the launches ran and their
    results were right.  So the profiler warms up first (its schedule's
    warm-up step, whose records are dropped, running WARMUP_LAUNCHES small
    launches and waiting WARMUP_S) and records only the block.  Records
    of kernels launched right after the trace began recording were still
    lost now and then (a decode wave's traced paged launches read 1800 of
    1824 on the H100), so the block starts SETTLE_S after recording
    begins, and recording stops SETTLE_S after the block's work has ended
    (``trace_probe.py`` counts lost records with and without the
    waits).  The session holds ``PROFILER_LOCK``: a block waits for a
    ``start_profile`` trace of the same process to end."""
    counts = {k: 0 for k in kernels}
    if not torch.cuda.is_available():
        yield counts
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with PROFILER_LOCK, profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(WARMUP_LAUNCHES):
            warm.add_(1)
        torch.cuda.synchronize()
        time.sleep(WARMUP_S)
        prof.step()                      # warm-up -> recording
        time.sleep(SETTLE_S)
        yield counts
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for k in kernels:
            if KERNEL_NAMES[k] in e.key:
                counts[k] += int(e.count)

"""Where a probe or benchmark runs and how it is timed: the device an entry
point resolves to, the card's name, clock and pipe rates, the library's
build time, and device and host timers.  Shared by ``roofline_probe``,
``kernel_bench``, ``rlc_bench`` and ``chip_smoke.py``."""

from __future__ import annotations

import functools
import subprocess
import time

import torch

from ..ops import ed25519_torch, kernels

SPIN_S = 0.05  # the card spins this long before timed launches, so they queue


def resolve(device: str | None) -> torch.device:
    """``cuda`` unless `device` names another; without a card that
    raises."""
    return ed25519_torch.resolve_device(device)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@functools.cache
def max_clock_mhz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0])


def pipe_rates(dev: torch.device) -> dict[str, float]:
    """``kernels.pipe_rates`` on every SM of the card at its top clock."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return kernels.pipe_rates(sms, max_clock_mhz())


def platform(dev: torch.device) -> dict:
    """The keys that name where a result was measured."""
    if dev.type == "cuda":
        return {"platform": "gpu", "device": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "device": "cpu"}


def build_seconds() -> float:
    """Seconds spent now building and loading the kernel library: 0 once
    it is loaded in this process."""
    if kernels.library.cache_info().currsize:
        return 0.0
    t0 = time.perf_counter()
    kernels.library()
    return time.perf_counter() - t0


def device_times_ms(fn, reps: int) -> list[float]:
    """Device ms of `reps` launches of fn, each between its own pair of
    CUDA events, after a spin that queues them all."""
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(int(max_clock_mhz() * 1e6 * SPIN_S))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def host_times_ms(fn, reps: int) -> tuple[object, list[float]]:
    """(the first run's result, host-clock ms of each of `reps` runs,
    each ending in a synchronise where the result is on the card)."""
    results, times = [], []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        results.append(fn())
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return results[0], times

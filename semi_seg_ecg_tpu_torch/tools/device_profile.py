"""Where a measuring tool runs, how it times and what a trace says: the
helpers shared by the port's tools (``tools/bench.py`` and the rest) and
``chip_smoke.py``.

- :func:`tool_device`: the card unless the caller asks for the CPU; with
  no card it raises, so a tool never carries on on the CPU unasked;
  :func:`device_identity`: the card's name, count and power limit
  (``nvidia-smi``), every field None on the CPU;
- time: :func:`wall_ms` (the host clock around calls that end in a
  synchronize), :func:`trial_ms` (trials of it: median and spread),
  :func:`event_ms` (CUDA events around calls queued on the card);
- traces: :func:`trace_device` (a ``torch.profiler`` window: device ms by
  kernel, device events, copy and elementwise kernels, a region's device
  ms, the all-reduces' host ms), :func:`device_window` (busy ms, idle
  share against an untraced wall time, top kernels and the rollup by
  :func:`category`), :func:`profile_forward` (a call's wall time with its
  window: serving) and :func:`profile_step` (a step's: training);
- the MFU denominator: :data:`PEAK_FLOPS` and :data:`HBM_BYTES_PER_S`, the
  published dense peaks of one H100 SXM at its 700 W power limit, which
  :func:`peak_flops` hands out only for a card whose name says H100 and
  HBM3 (any other card, and the CPU, get None: no guess).

Every device metric of a CPU run is None: a CPU's times are no card's.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import time
from typing import Callable, ContextManager, Dict, Optional

import torch

# H100 SXM data-sheet peaks (dense, 700 W): device memory and the rate of
# the units a product runs on: fp32 on the CUDA cores, bf16 on the tensor
# cores, and fp32-accurate products on the tensor cores as three TF32
# products each (3xTF32: 495 / 3 TFLOP/s, the fp32 flash kernels' rate)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "3xtf32": 495e12 / 3}

# the needles of the port's kernels in a trace (their CUDA function names)
FLASH_FWD, FLASH_BWD, GATHER = "flash_fwd_", "flash_bwd_", "gather1d_kernel"
CATEGORIES = ("gemm_conv", "flash", "gather", "elementwise_copy", "nccl",
              "other")
_GEMM_CONV = ("gemm", "conv", "cutlass", "xmma", "cudnn", "cublas", "dgrad",
              "wgrad", "fprop", "sm90_", "sm80_")
_COPY = ("elementwise", "copy", "memcpy", "memset", "nchwtonhwc",
         "nhwctonchw", "cat", "fill")


def tool_device(name: str = "cuda") -> torch.device:
    """The device a tool measures: ``cpu`` when asked for, else the card;
    raises where there is none."""
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("cuda", "gpu"):
        raise ValueError(f"device {name!r}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is False: this tool measures the "
            "CUDA card; pass --device cpu for a rehearsal on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def device_identity(device: torch.device) -> Dict[str, Optional[object]]:
    """``platform`` (``gpu`` / ``cpu``), ``kind``
    (``torch.cuda.get_device_name``), ``count``, and ``power_limit``, the
    first card's ``nvidia-smi`` line; None where there is no card."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": None, "count": 0,
                "power_limit": None}
    smi = nvidia_smi().splitlines()[0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "power_limit": smi.split(",")[-1].strip()}


def peak_flops(kind: Optional[str]) -> Optional[float]:
    """The published dense bf16 peak of a card named ``kind``: an H100
    with HBM3 (the SXM part) only, else None."""
    if kind is None or "H100" not in kind or "HBM3" not in kind:
        return None
    return PEAK_FLOPS["bfloat16"]


def mfu(flops: Optional[float], ms: Optional[float],
        kind: Optional[str]) -> Optional[float]:
    """``flops`` done in ``ms`` over the card's bf16 peak; None without
    any of the three."""
    peak = peak_flops(kind)
    if not flops or not ms or peak is None:
        return None
    return flops / (ms / 1e3) / peak


def on_card(device: torch.device, value):
    """``value`` for a measurement on the card, None for one on the CPU:
    a device metric of a CPU run is no card's."""
    return value if device.type == "cuda" else None


def allocated_bytes(device: torch.device) -> int:
    """The device memory the process holds now (0 on the CPU)."""
    return torch.cuda.memory_allocated(device) \
        if device.type == "cuda" else 0


def peak_mb(device: torch.device, held: int = 0) -> Optional[float]:
    """The peak of allocated device memory since the last
    ``reset_peak_memory_stats``, less ``held`` bytes that were allocated
    before the measured run (earlier work of the process), in MiB; None
    on the CPU."""
    if device.type != "cuda":
        return None
    return (torch.cuda.max_memory_allocated(device) - held) / 2 ** 20


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn: Callable[[], object], calls: int,
            device: torch.device) -> float:
    """Host-clock ms a call of ``fn`` over ``calls`` calls, synchronized
    before and after."""
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / calls


def trial_ms(fn: Callable[[], object], calls: int, device: torch.device,
             trials: int = 3, warmup: int = 2) -> Dict[str, object]:
    """:func:`wall_ms` over ``calls`` calls in each of ``trials`` trials,
    after ``warmup`` calls: ``{"ms", "trials_ms", "spread"}``, the median,
    each trial's, and (max - min) / median."""
    for _ in range(warmup):
        fn()
    each = [wall_ms(fn, calls, device) for _ in range(trials)]
    med = statistics.median(each)
    return {"ms": med, "trials_ms": each,
            "spread": (max(each) - min(each)) / med}


def event_ms(fn: Callable[[], object], iters: int, warmup: int = 3,
             sleep: bool = True, before: Optional[Callable] = None) -> float:
    """Device ms per call: CUDA events around ``iters`` calls after
    ``warmup`` ones (then ``before``, a barrier say). With ``sleep`` the
    calls queue behind a sleep kernel of about a millisecond a call, so
    the host's enqueue cost stays off the clock (SDPA's backward through
    autograd costs the host hundreds of microseconds a call in a fresh
    process)."""
    for _ in range(warmup):
        fn()
    if before is not None:
        before()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep:
        torch.cuda._sleep(max(100_000_000, 2_000_000 * iters))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_counts() -> Dict[str, int]:
    """The port's kernel launches since import, by kernel (each wrapper
    counts where it launches its kernel): read before and after a run, the
    difference is the run's."""
    from ..ops import flash_attention as fa
    from ..ops import gather1d

    return {"flash_attention_fwd": fa.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES,
            "gather1d": gather1d.LAUNCHES}


def kernel_kind(name: str) -> Optional[str]:
    """'copy' for PyTorch's copy and cast kernels (and memcpys), else
    'elementwise' for its other elementwise kernels, else None."""
    low = name.lower()
    if "copy" in low or "memcpy" in low:
        return "copy"
    if "elementwise" in low:
        return "elementwise"
    return None


def category(name: str) -> str:
    """A device event's share of the rollup: ``flash`` (the port's flash
    kernels), ``gather`` (its gather), ``nccl``, ``gemm_conv`` (cuBLAS,
    cuDNN and CUTLASS products and convolutions), ``elementwise_copy``
    (PyTorch's elementwise, copy, cast, fill and layout kernels, memcpys)
    or ``other`` (reductions, norms, softmax, the rest)."""
    low = name.lower()
    if FLASH_FWD in low or FLASH_BWD in low:
        return "flash"
    if GATHER in low:
        return "gather"
    if "nccl" in low:
        return "nccl"
    if any(k in low for k in _GEMM_CONV):
        return "gemm_conv"
    if any(k in low for k in _COPY):
        return "elementwise_copy"
    return "other"


def kernel_ms(per_kernel: Dict[str, float], *needles: str
              ) -> Optional[float]:
    """The summed ms of the kernels whose names hold any of ``needles``;
    None for an empty trace."""
    if not per_kernel:
        return None
    return sum(v for k, v in per_kernel.items()
               if any(n in k for n in needles))


def region_device_us(events, range_name: str, sequence_nrs) -> float:
    """Device µs of a region of a traced run: the kernels launched inside
    the host ranges named ``range_name`` (its forward) and inside the
    backward's ``evaluate_function`` ranges of the autograd nodes whose
    sequence numbers are ``sequence_nrs`` (its backward, each node's
    gradient accumulation included)."""
    from torch.autograd import DeviceType

    backward = "autograd::engine::evaluate_function:"
    total = 0.0
    for event in events:
        if event.device_type != DeviceType.CPU:
            continue
        if event.name == range_name or (
                event.name.startswith(backward)
                and event.sequence_nr in sequence_nrs):
            total += event.device_time_total
    return total


def trace_device(fn: Callable[[], object], steps: int, region=None):
    """Device time of ``steps`` calls of ``fn`` from a torch.profiler
    trace: ``(traced wall ms a call, {kernel: device ms a call}, device
    events a call, {"copy", "elementwise"}: such kernels a call, the
    region's device ms a call (with ``region``, see
    :func:`region_device_us`, else None), the host ms a call inside the
    process group's all-reduces (its ``gloo:all_reduce`` /
    ``nccl:all_reduce`` ranges))``. The kernel map is empty when the trace
    holds no device events (a CPU run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        if cuda:
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps
    region_ms = (region_device_us(prof.events(), *region) / 1e3 / steps
                 if region else None)
    per_kernel, count, kinds = {}, 0, {"copy": 0, "elementwise": 0}
    allreduce_us = 0.0
    for event in prof.events():
        if event.device_type == DeviceType.CPU and \
                event.name.endswith(":all_reduce"):
            allreduce_us += event.cpu_time_total
        # user annotations (the optimizer's step range) span kernels that
        # the trace also lists, so they are not device work of their own
        if event.device_type == DeviceType.CUDA and not getattr(
                event, "is_user_annotation", False):
            count += 1
            per_kernel[event.name] = (per_kernel.get(event.name, 0.0)
                                      + event.time_range.elapsed_us() / 1e3)
            kind = kernel_kind(event.name)
            if kind:
                kinds[kind] += 1
    return (traced_ms, {k: v / steps for k, v in per_kernel.items()},
            count / steps, {k: v / steps for k, v in kinds.items()},
            region_ms, allreduce_us / 1e3 / steps)


def trace_file_kernels(path: str):
    """A Chrome trace's device events (kernels, memcpys, memsets, as
    ``torch.profiler``'s ``export_chrome_trace`` writes them):
    ``({name: total ms}, {name: events})``, both empty for a trace with
    no device events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ms, counts = {}, {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in e:
            ms[e["name"]] = ms.get(e["name"], 0.0) + e["dur"] / 1e3
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return ms, counts


def device_window(per_kernel: Dict[str, float], wall: Optional[float],
                  top: int = 10) -> Dict[str, object]:
    """What a trace's kernels say against an untraced wall time ``wall``
    (ms a call; tracing slows the host, not the kernels): ``device_busy_ms``,
    ``device_idle_share``, the ``top`` kernels by device ms and the ms of
    each :data:`CATEGORIES` entry; None for an empty trace. On a saturated
    card the idle share can read a little below 0: the kernels' traced
    durations run a fraction of a percent longer than untraced ones."""
    if not per_kernel:
        return {"device_busy_ms": None, "device_idle_share": None,
                "top_kernels": None, "categories_ms": None}
    busy = sum(per_kernel.values())
    cats = dict.fromkeys(CATEGORIES, 0.0)
    for name, ms in per_kernel.items():
        cats[category(name)] += ms
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall if wall else None,
            "top_kernels": [[k, v] for k, v in ranked],
            "categories_ms": cats}


def profile_forward(fn: Callable[[], object], batch: int, steps: int,
                    device: torch.device, top: int = 8) -> Dict[str, object]:
    """One call of ``fn`` (a forward of ``batch`` windows) after a warm
    one: its host-clock ``wall_ms`` (synchronized), ``windows_per_s``,
    and from a trace of ``steps`` more calls :func:`device_window`'s
    numbers, ``device_events``, ``copy_kernels``, ``elementwise_kernels``
    and ``flash_kernel_ms``; every time None on the CPU."""
    fn()
    ms = wall_ms(fn, steps, device)
    traced_ms, per_kernel, events, kinds, _, _ = trace_device(fn, steps)
    window = device_window(per_kernel, ms, top)
    traced = bool(per_kernel)
    return {"batch": batch, "wall_ms": on_card(device, ms),
            "windows_per_s": on_card(device, batch / ms * 1e3),
            "traced_wall_ms": on_card(device, traced_ms), **window,
            "device_events": events if traced else None,
            "copy_kernels": kinds["copy"] if traced else None,
            "elementwise_kernels": kinds["elementwise"] if traced else None,
            "flash_kernel_ms": kernel_ms(per_kernel, FLASH_FWD)}


def profile_step(step: Callable[[], object], steps: int,
                 device: torch.device, *, warmup: int = 2, chunks: int = 1,
                 traced: Optional[int] = None,
                 region: Optional[Callable[[], ContextManager]] = None,
                 launches: Optional[Callable[[], Dict[str, int]]] = None,
                 top: int = 10) -> Dict[str, object]:
    """``steps`` calls of ``step`` after ``warmup`` (a captured run's
    warm-up and capture among them), in ``chunks`` windows: the wall ms a
    step (synchronized at each window's end; each window's too, the
    spread), the host's µs a step (each window's issue time before its
    synchronize), the peak of allocated device memory, and with
    ``launches`` (a reader of the port's launch counters) the launches a
    step; from a trace of ``traced`` more steps (``steps`` by default) the
    device busy ms, the idle share of the untraced wall and of the traced
    one, device events, copy and elementwise kernels a step, each ported
    kernel's ms, the collectives' ms, the all-reduces' host ms, the
    region's device ms (``region``: a context manager factory, entered
    around the trace only, that yields :func:`trace_device`'s region), top
    kernels and the rollup. Every time is None on the CPU."""
    per_window = max(steps // chunks, 1)
    for _ in range(warmup):
        step()
    synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = launches() if launches else None
    windows, issued_s = [], 0.0
    for _ in range(chunks):
        t0 = time.perf_counter()
        for _ in range(per_window):
            step()
        issued = time.perf_counter()
        synchronize(device)
        windows.append((time.perf_counter() - t0) * 1e3 / per_window)
        issued_s += issued - t0
    n = per_window * chunks
    per_step = None
    if launches:
        after = launches()
        per_step = {k: (after[k] - before[k]) / n for k in after}
    peak_mb = (torch.cuda.max_memory_allocated(device) / 2 ** 20
               if device.type == "cuda" else None)
    with region() if region else contextlib.nullcontext() as spans:
        traced_ms, per_kernel, events, kinds, region_ms, \
            allreduce_host_ms = trace_device(step, traced or steps, spans)
    wall = sum(windows) / len(windows)
    window = device_window(per_kernel, wall, top)
    card = functools.partial(on_card, device)
    busy = window["device_busy_ms"]
    traced_any = bool(per_kernel)
    return {"steps": n, "wall_ms_per_step": card(wall),
            "wall_ms_per_step_windows": card(windows),
            "host_us_per_step": card(issued_s * 1e6 / n),
            "peak_memory_mb": peak_mb, "launches_per_step": per_step,
            "traced_steps": traced or steps,
            "traced_wall_ms_per_step": card(traced_ms),
            "device_busy_ms_per_step": busy,
            "device_idle_share": window["device_idle_share"],
            "device_idle_share_traced": (1 - busy / traced_ms) if busy
            else None,
            "device_events_per_step": events if traced_any else None,
            "copy_kernels_per_step": kinds["copy"] if traced_any else None,
            "elementwise_kernels_per_step": kinds["elementwise"]
            if traced_any else None,
            "flash_fwd_ms_per_step": kernel_ms(per_kernel, FLASH_FWD),
            "flash_bwd_ms_per_step": kernel_ms(per_kernel, FLASH_BWD),
            "gather_ms_per_step": kernel_ms(per_kernel, GATHER),
            # under a process group: the collectives' kernels
            "collectives_ms_per_step": kernel_ms(per_kernel, "nccl"),
            "allreduce_ms_per_step": kernel_ms(per_kernel, "AllReduce"),
            # the same all-reduces' host time (gloo's run on the host)
            "allreduce_host_ms_per_step": allreduce_host_ms,
            "region_ms_per_step": region_ms if traced_any else None,
            "top_kernels_ms_per_step": window["top_kernels"],
            "categories_ms_per_step": window["categories_ms"]}

"""Timing and tracing (port of gamd_tpu/utils/profiling.py: Timer,
profile_trace), and the parse of a torch.profiler run into device spans and
per-kernel device times that the profiling tools share (tools/
profile_step.py, profile_train.py, time_conv.py, time_encoder.py,
trace_force.py).

    t = Timer()
    out = f(x)
    seconds = t.stop(out)      # after the device of out has finished

    with profile_trace("/tmp/trace") as prof:
        run()
    kernels = kernel_times(prof)
"""

import contextlib
import os
import re
import time

import torch


def _cuda_devices(result, found):
    """The CUDA devices of every tensor in a nest of tensors, lists,
    tuples and dicts."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            found.add(result.device)
    elif isinstance(result, dict):
        for value in result.values():
            _cuda_devices(value, found)
    elif isinstance(result, (list, tuple)):
        for value in result:
            _cuda_devices(value, found)
    return found


class Timer:
    """Wall-clock timer that waits for the device of its result: stop(out)
    synchronises every CUDA device holding a tensor of out (a tensor or a
    nest of them), then returns the seconds since the timer was made."""

    def __init__(self):
        self.start = time.perf_counter()

    def stop(self, result=None):
        for device in _cuda_devices(result, set()):
            torch.cuda.synchronize(device)
        return time.perf_counter() - self.start


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the block with torch.profiler (CPU activity, and the CUDA
    device's where there is one) and write its Chrome trace to
    logdir/trace.json. Yields the profiler, whose events the block's
    caller may parse (kernel_times, device_spans)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def short_name(kernel: str) -> str:
    """A readable name for a device kernel: this repo's kernels by their
    own name (the tile kernels with their source policy, and a stage
    policy other than the conv message's; node_fused_kernel and
    conv_update_kernel with their atoms a block, B, whatever benchmark
    form and activations node_fused_kernel takes), PyTorch's by the kernel template and
    the op it runs."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    base = re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()
    rest = name[len(name.split("<", 1)[0]):]
    rows = re.search(r"\b(ClampedSrc|PreSrc|GatherSrc|BandSrc|AllSlots|"
                     r"LiveSlots)\b", rest)
    if rows:   # conv_tile_kernel's, encoder_tile_kernel's
        stages = ",ThetaStages" if re.search(r"\bThetaStages\b", rest) \
            else ""
        return f"{base}[{rows.group(1)}{stages}]"
    width = re.match(r"<(\d+)(?:, ?\d+)*>", rest)   # B, then form, acts
    if base in ("node_fused_kernel", "conv_update_kernel") and width:
        return f"{base}[B={width.group(1)}]"
    ops = re.findall(r"(\w+_kernel_cuda|\w+Functor|\w+_cuda_out)", rest)
    return f"{base}[{ops[-1]}]" if ops else (base or kernel[:60])


def on_device(evt) -> bool:
    """A device activity of a profiler run (a kernel, copy or memset); user
    annotations such as Optimizer.step's, which span other kernels and the
    gaps between them, are not."""
    return evt.device_type == torch.autograd.DeviceType.CUDA \
        and not getattr(evt, "is_user_annotation", False)


def device_spans(prof) -> list:
    """(start us, end us, short name) of every device activity, by start."""
    return sorted((e.time_range.start, e.time_range.end, short_name(e.name))
                  for e in prof.events() if on_device(e))


def traced_spans(fn, calls, tries=3) -> list:
    """device_spans of `calls` calls of fn in one torch.profiler session
    (device activity only), after an untraced call. Now and then a
    session delivers no device activity at all; such a session is run
    again, up to `tries` sessions. [] if none saw any."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = device_spans(prof)
        if spans:
            return spans
    return []


def exclusive_times(spans) -> tuple:
    """Device time as a partition of the busy time: each activity gets what
    it adds beyond the latest end before it (the running frontier), so
    overlapping spans (a kernel started early by programmatic dependent
    launch, waiting for the one before it) are not counted twice. Returns
    ({short name: {"us", "count"}}, [(gap us, name before, name after)]
    between an activity and the frontier before it)."""
    kernels, gaps = {}, []
    frontier, last = None, None
    for start, end, name in spans:
        if frontier is not None:
            gaps.append((max(0.0, start - frontier), last, name))
        entry = kernels.setdefault(name, {"us": 0.0, "count": 0})
        entry["us"] += max(0.0, end - (start if frontier is None
                                       else max(start, frontier)))
        entry["count"] += 1
        if frontier is None or end >= frontier:
            frontier, last = end, name
    return kernels, gaps


def kernel_times(prof) -> dict:
    """{short name: {"us": device time summed, "count": launches}} of the
    device activities a torch.profiler run saw."""
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = evt.cuda_time_total
        if on_device(evt) and dev_us > 0:
            entry = kernels.setdefault(short_name(evt.key),
                                       {"us": 0.0, "count": 0})
            entry["us"] += dev_us
            entry["count"] += evt.count
    return kernels

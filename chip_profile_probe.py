"""How often a torch.profiler trace misses a device-kernel record in
chip_smoke.py's per-call kernel count (phase 6, ``_device_kernels_per_call``),
with the trace started at its first launch ("old") and with a warm-up step
before the recorded one ("new", the smoke's own ``_kernels_per_call``).

    python3 chip_profile_probe.py [ITERATIONS]    # on one GPU, default 15

Each iteration takes the three traces of phase 6 by each method and prints
every failed count; the last line gives the failures by method."""
import sys
import time

import torch

import chip_smoke as cs


def old_kernels_per_call(groups, calls=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, call, _ in groups:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, call, _ in groups:
            for _ in range(calls):
                call()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA and not e.key.startswith("Mem"):
            kernels[e.key] = kernels.get(e.key, 0) + e.count
    n = sum(kernels.values())
    wants = [want for _, _, expected in groups for want in expected]
    if n != len(wants) * calls:
        raise AssertionError(f"old: {n} of {len(wants) * calls}: {kernels}")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 15
    cs.device_info()
    cs.build()
    new = cs._kernels_per_call
    fails = {"old": [], "new": []}
    t0 = time.perf_counter()
    for i in range(n):
        for label, fn in (("old", old_kernels_per_call), ("new", new)):
            cs._kernels_per_call = fn
            try:
                cs._device_kernels_per_call()
            except AssertionError as e:
                fails[label].append(str(e)[:600])
                print(f"iter {i} {label}: FAIL {str(e)[:600]}", flush=True)
        print(f"iter {i} done, {time.perf_counter() - t0:.1f} s", flush=True)
    print({k: len(v) for k, v in fails.items()}, f"of {n} iterations x 3 traces each")


if __name__ == "__main__":
    main()

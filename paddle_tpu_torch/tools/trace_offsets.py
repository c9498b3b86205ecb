"""Run ``chip_smoke.py`` whole on one GPU, with a line after every
torch.profiler trace it takes.

    python3 paddle_tpu_torch/tools/trace_offsets.py [chip_smoke.py arguments]

Each line gives the seconds since start, the trace's device records and
launch calls (the host's ``cudaLaunchKernel``, ``cudaGraphLaunch`` and
the like), the first device record's start less the first launch call's
start and the last device record's end less the last launch call's end
(ms, on the trace's own clock), and the host events' span (ms). A trace
that lost a leading run of records shows a first record far behind its
first launch, or none. The smoke's own output and exit code are kept.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv):
    t_start = time.monotonic()
    import torch
    import torch.profiler as TP

    import chip_smoke
    cuda = torch.autograd.DeviceType.CUDA
    base = TP.profile

    class Traced(base):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            ev = self.events()
            dev = [e.time_range for e in ev if e.device_type == cuda]
            calls = [e.time_range for e in ev
                     if e.device_type != cuda and "aunch" in e.name]
            host = [e.time_range for e in ev if e.device_type != cuda]
            first = last = span = None
            if dev and calls:
                first = (min(t.start for t in dev)
                         - min(t.start for t in calls)) / 1e3
                last = (max(t.end for t in dev)
                        - max(t.end for t in calls)) / 1e3
            if host:
                span = (max(t.end for t in host)
                        - min(t.start for t in host)) / 1e3
            print(f"    [trace t={time.monotonic() - t_start:.0f}s: "
                  f"{len(dev)} device records, {len(calls)} launch calls; "
                  f"first record - first launch {first} ms; last record end"
                  f" - last launch end {last} ms; host span {span} ms]",
                  flush=True)
            return out

    TP.profile = Traced
    return chip_smoke.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

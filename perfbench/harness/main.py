"""One run of one cell: set-up, the measured window, the traced segment of a
``--trace 1`` run, the check of the outputs against the plain reference,
and the result line."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

from . import guard, spec

CACHE = os.path.join(spec.HERE, ".cache")


def _args(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv, t0: float) -> int:
    a = _args(argv)
    # the program's and the compilers' build caches: fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    w = spec.workload(a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = measure(a, torch.device("cuda", 0), t0, w)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


def measure(a, dev, t0: float, w: dict, conf: dict | None = None, mix: dict | None = None):
    """One run of the cell ``w`` on ``dev``: the result line's object, or
    None where the process holds what it may not. ``conf`` and ``mix``
    replace the cell's own files (the CPU rehearsal in the tests)."""
    import torch

    conf = conf or spec.config(w["config"])
    mix = mix or spec.traffic(w["traffic"])
    e2e = spec.end_to_end(w["name"])
    layers = spec.per_layer(w["name"])
    path = importlib.import_module(f"perfbench.paths.{w['path']}")
    torch.set_num_threads(w["host_threads"])

    run = path.Run(w, conf, mix, a.seed, dev, t0)
    run.setup()
    run.window(a.seconds)
    if not _clean():
        return None
    metrics = {k: v for k, v in run.end_to_end().items() if k in e2e}
    result = {}
    if a.trace:
        from perfbench.metrics.readers import read_all

        reading = run.traced_segment()
        metrics = read_all(layers, reading)
        result["breakdown"] = reading.breakdown()
        busy, window = reading.busy_and_window()
        print(f"trace: {reading.describe()}", file=sys.stderr)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
              "count": w["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    if a.trace:
        device.update(busy_s=busy, window_s=window)
    attempted, failed = run.attempted, run.failed
    run.free()
    checks = run.check()
    if not _clean():
        return None
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    if dev.type == "cuda":
        print(f"card: {_power_limit()}", file=sys.stderr)
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    result.update(correct=correct, attempted=attempted, failed=failed, device=device)
    result["metrics"] = {k: {"value": v, "unit": (e2e.get(k) or layers.get(k))["unit"]} for k, v in metrics.items()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def _clean() -> bool:
    found = guard.banned_loaded()
    if found:
        print(f"the measured process holds {', '.join(found)}; it may hold none of "
              f"{', '.join(sorted(guard.BANNED))}", file=sys.stderr)
    return not found

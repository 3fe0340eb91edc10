"""The benchmark of the PyTorch and CUDA port (``t5gemma_tts_tpu_torch``) on
NVIDIA cards. One process runs one cell once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It sets up (weights drawn on the card from
the seed, the program's builds, captures and warm-up: ``setup_s``),
measures for ``--seconds``, checks what the timed path produced against the
plain reference in ``benchmark/reference/``, and prints one JSON line last
on standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (read from a device trace of a stretch
of the window and from the harness's own counts). ``--control`` runs the
traffic file's lower-precision path of the program in its place: the
control that the correctness limits are set against.
"""

from __future__ import annotations

import time

T_ORIGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import guard, spec  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e30


def result_line(cell: spec.Cell, record, trace: bool, device_kind: str,
                correct: bool, limits: dict) -> dict:
    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = spec.metric_reader(cell, m["name"])
            value = None if reader is None else reader.read(record.facts,
                                                            record.trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in record.end_to_end:
                metrics[m["name"]] = {"value": float(record.end_to_end[
                    m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(record.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(record.attempted),
            "failed": int(record.failed), "metrics": metrics,
            "device": device}
    if trace and record.trace is not None:
        device["busy_s"] = record.trace.busy_s()
        device["window_s"] = record.trace.window_s
        line["breakdown"] = record.trace.breakdown()
    line["checks"] = {k: {"value": _finite(record.checks.get(k, math.inf)),
                          "limit": v} for k, v in limits.items()}
    return line


def judge(checks: dict, limits: dict) -> bool:
    """Every number compared at or under its limit, and every limit met by
    a number."""
    if not limits or set(limits) - set(checks):
        return False
    return all(math.isfinite(checks[k]) and checks[k] <= limits[k]
               for k in limits)


def main(argv=None) -> int:
    args = parse(argv)
    guard.set_environment(ROOT)
    cell = spec.load_cell(args.workload, ROOT)
    device_kind = guard.check_cards(cell.chips)
    mode = spec.mode_module(cell)
    record = mode.run(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda",
                      control=args.control, t_origin=T_ORIGIN)
    found = guard.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    correct = judge(record.checks, cell.limits) and record.failed == 0
    line = result_line(cell, record, bool(args.trace), device_kind, correct,
                       cell.limits)
    reported = {m["name"] for m in cell.end_to_end}
    for k, v in list(record.notes.items()) + [
            (k, v) for k, v in record.end_to_end.items()
            if k not in reported]:
        print(f"[note] {k}: {v}", file=sys.stderr)
    print(f"[result] correct={correct} attempted={record.attempted} "
          f"failed={record.failed}", file=sys.stderr)
    for k, v in record.checks.items():
        if k not in cell.limits:
            print(f"[note] {k} (not compared): {v!r}", file=sys.stderr)
    for k, v in cell.limits.items():
        print(f"[check] {k} {record.checks.get(k)!r} limit {v!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
# SPDX-License-Identifier: Apache-2.0
"""One serve phase of ``chip_smoke.py`` and its profile, on this tree and on
an earlier tree of the repo, in turns (earlier, current, current, earlier),
one process a run, on one card.

    python3 scripts/torch_profile_parent.py --old-root DIR [--phase serve_a8w4]

``DIR`` is the root of an earlier tree (``git archive`` of that commit
unpacked under ``_archive/``), whose ``chip_smoke.py`` has the phase's
``phase_<name>(card, cfg, dense)``. Both trees' kernels are built first, at
once; then each run builds the phase's random 4-layer model from the same
seed, serves it with the phase's checks and prints the phase's JSON lines.
Prints one summary line a run (the warm pass's device time, wall, busy
share, TTFT and device time by group) and exits 1 when a run fails.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

BUILD = "import chip_smoke as cs; cs.phase_build()"
RUN = ("import chip_smoke as cs; card = cs.card_line(); cfg, dense = cs.dense_llama(); "
       "cs.phase_{phase}(card, cfg, dense)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-root", type=Path, required=True)
    ap.add_argument("--phase", default="serve_a8w4")
    args = ap.parse_args()
    trees = {"parent": args.old_root.resolve(), "change": ROOT}
    builds = {name: subprocess.Popen([sys.executable, "-c", BUILD], cwd=root,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for name, root in trees.items()}
    for name, proc in builds.items():
        out, err = proc.communicate()
        if proc.returncode:
            print(err[-4000:], file=sys.stderr)
            raise SystemExit(f"{name}: build failed")
    profile = "profile_" + args.phase.removeprefix("serve_")
    failed = 0
    for name in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "-c", RUN.format(phase=args.phase)],
                              cwd=trees[name], capture_output=True, text=True)
        lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
        prof = next((ln for ln in lines if ln.get("phase") == profile), None)
        if proc.returncode or prof is None:
            failed += 1
            print(proc.stderr[-4000:], file=sys.stderr)
            print(json.dumps({"tree": name, "ok": False, "rc": proc.returncode}), flush=True)
            continue
        warm = prof["warm"]
        print(json.dumps({"tree": name, "ok": True, "phase": profile,
                          "warm_device_ms": warm["device_ms"],
                          "warm_wall_ms": warm["wall_ms_unprofiled"],
                          "warm_busy": warm["device_busy_share"],
                          "warm_ttft_ms": warm["ttft_ms"],
                          "warm_by_group": warm["device_ms_by_group"],
                          "warm_top": warm["top"], "card": prof.get("card")}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of the check: on each seed, a short window of the cell at
its own size, and both the program's numbers and those of the reference
computed in bfloat16 put in the program's place.

    python3 -m portbench.control --workload atrium-path --seconds 5 --seeds 11 12 13

Prints one JSON line a seed: ``program`` and ``control``, each a list of
[number, value, limit, within]. A limit is sound only where the control
fails some number and the program's readings stay inside every one. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import harness

    for seed in args.seeds:
        r = harness.run(args.workload, seed, args.seconds, False, control=True)
        prog = [[k, v[0], v[1], v[1] is not None and v[0] <= v[1]] for k, v in r["check"].items()]
        print(json.dumps(dict(workload=args.workload, seed=seed, correct=r["correct"],
                              program=prog, control=r["control"],
                              control_fails=any(not ok for *_, ok in r["control"]),
                              judged=r["judged"], card=r["card"])), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Run one cell of BENCHMARK.json on this machine's card.

    python3 -m portbench.run --workload atrium-path --seed 7 --seconds 40 --trace 0

Prints the compared numbers with their limits as the last lines of
standard error and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, ``window`` (the calls, their mean and
standard deviation), ``judged`` (what the check looked at) and ``check``
last. Exits 3 without printing a
result where there is no card, or too few, and 4 where JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace))
    except harness.NoCard as e:
        print(e, file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the port must not load: {found}", file=sys.stderr)
        return 4
    for name, (value, limit) in result["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The readings a cell's correctness limits are set from, on the card.

    python3 -m splatbench.control --workload <cell> --seeds <n> [<n> ...]
        [--program SECONDS [--fault NAME]]

Per seed, one JSON line: the control's numbers (the plain reference in
bfloat16 put in the program's place, against the float32 reference); with
``--program`` the program's own numbers from a run of that many seconds,
with ``--fault`` planted in it (``splatbench.faults``).  All seeds run in
one process, so the kernels build once.  The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from . import faults, harness, run


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", type=int, nargs="+", required=True)
  ap.add_argument("--program", type=float, default=0.0)
  ap.add_argument("--fault", choices=sorted(faults.FAULTS))
  args = ap.parse_args(argv)
  cell = harness.Cell(args.workload, harness.spec())
  dev = harness.card(cell.chips)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  for seed in args.seeds:
    if args.program:
      with (faults.planted(args.fault) if args.fault
            else contextlib.nullcontext()):
        res, _ = run.run(run.parse(
            ["--workload", args.workload, "--seed", str(seed), "--seconds",
             str(args.program)]), dev=dev)
      numbers = {k: v["value"] for k, v in res["checks"].items()}
      line = {"seed": seed, "program": numbers, "failed": res["failed"],
              "fault": args.fault}
    else:
      loop = cell.loop().Loop(cell, dev, seed, harness.Timer(False))
      line = {"seed": seed, "control": loop.control()}
      del loop
    torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())

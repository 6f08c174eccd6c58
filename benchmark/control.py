"""The readings that the check's limits are set from.

  python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]
      [--arms program fp8 half_batch stale_grad bf16] [--device cuda|cpu]

For each seed, in one process: the cell's set-up and checked steps as a
run makes them (`run.Setup`), the program's state freed, the reference in
float32, and beside it each arm: `program` (the port, as every run compares
it), `fp8` (the control: the reference with every product's operands
rounded to float8 e4m3, one step below the configuration's bf16),
`half_batch` (a fault: the reference with the loss over half the batch's
images), `stale_grad` (a fault: the last step's update fed the step
before's gradient, as a replay reading a stale buffer would) and `bf16`
(a witness: the reference with bf16 products). Prints one JSON line per
seed and arm with the numbers and the leaves of the worst gaps, then the
card's name and power limit. The benchmark's own runs never run this;
`tests/test_bench_control.py` runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile


def readings_for(cell, seeds, arms, device="cuda") -> list:
    import torch

    from benchmark import check
    from benchmark.run import Setup

    device = torch.device(device)
    out = []
    for seed in seeds:
        tmp = tempfile.mkdtemp(prefix="yolat_control_")
        try:
            st = Setup(cell, seed, device, tmp)
            st.free()
            batches = st.reference_inputs(cell, seed, device)
            ref = check.run_reference(cell, batches, st.weights)
            for arm in arms:
                if arm == "program":
                    got = st.snap
                elif arm in ("half_batch", "stale_grad"):
                    got = check.run_reference(cell, batches, st.weights,
                                              fault=arm)
                else:
                    got = check.run_reference(cell, batches, st.weights,
                                              precision=arm)
                line = {"cell": cell.name, "seed": seed, "arm": arm,
                        **check.readings(got, ref, st.weights)}
                out.append(line)
                print(json.dumps(line), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv=None) -> None:
    from benchmark.manifest import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--arms", nargs="+",
                   default=["program", "fp8", "half_batch", "stale_grad",
                            "bf16"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    readings_for(load_cell(args.workload), args.seeds, args.arms,
                 args.device)
    if args.device == "cuda":
        dev = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(json.dumps({"device": dev}))


if __name__ == "__main__":
    main()

"""One eager canonical predict of the toy batch under `utils.profiling.trace`,
in a process of its own, with the trace's records of the port's kernels
held to the launches that their wrappers counted.

  python -m yolat_tpu_torch.scripts.traced_predict --out DIR
      [--device cuda|cpu] [--n_filters 64]

Builds the toy batch (`data.toy.toy_batch`: `random_packed_batch` of 4
images at seed 0, its node rows rounded up to a multiple of 512, as the
fused pool head needs), a canonical detector seeded with 0
(`nn.model.seeded_model`, 17 classes) folded for the fast engine, and runs the bf16 predict core
(`eval.predict.make_predict_core(..., bf16=True)`, fixpoint NMS) once
outside the trace (the kernels' build, the libraries' set-up) and once
inside it, `MARGIN` host seconds after the trace starts and before it
stops (`scripts/source_edits.py`: the profiler keeps a device record only
inside the trace's window on the host's clock). Then it reads the Chrome
trace that `trace` wrote into DIR: the device records of each port kernel
(`KERNELS`, by the kernel's name) against the launches its wrapper
counted in the traced call. A kernel with fewer or more records than
launches raises: the profiler dropped a record (no retake). DIR must hold
no other trace. Prints one JSON line {"trace", "launches", "records",
"cpu_ops", "detections"}.

On the card only a new process keeps every record (the profiler drops
them in a process that has run much on the card, PERF.md §7); with
`--device cpu` the wrappers run their plain versions, nothing launches
and the trace holds the CPU ops alone.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

# the CUDA kernels (by name) behind each counted wrapper of the canonical
# predict core (f32 and bf16 instantiations)
KERNELS = {
    "edge_window_message_sum": ("edge_window_kernel",
                                "edge_window_tc_kernel"),
    "folded_mlp_block_max2": ("block_max_kernel", "block_max_tc_kernel"),
    "nms_fixpoint": ("fixpoint_kernel",),
}


def kernel_records(path: str) -> tuple:
    """({wrapper: device records of its kernels}, CPU op records) of a
    Chrome trace."""
    from yolat_tpu_torch.scripts.source_edits import kernel_name

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = kernel_name(e.get("name", ""))
            names[k] = names.get(k, 0) + 1
    records = {w: sum(names.get(k, 0) for k in ks)
               for w, ks in KERNELS.items()}
    cpu_ops = sum(1 for e in events if e.get("cat") == "cpu_op")
    return records, cpu_ops


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_filters", default=64, type=int)
    args = p.parse_args(argv)

    import torch

    from yolat_tpu_torch.config import Config
    from yolat_tpu_torch.data.packing import to_device
    from yolat_tpu_torch.data.toy import toy_batch
    from yolat_tpu_torch.eval.fast_forward import fold_params
    from yolat_tpu_torch.eval.predict import img_slot_cap, make_predict_core
    from yolat_tpu_torch.nn.model import seeded_model
    from yolat_tpu_torch.ops import _build
    from yolat_tpu_torch.scripts.source_edits import MARGIN
    from yolat_tpu_torch.utils.profiling import trace

    dev = torch.device(args.device)
    batch_np, _ = toy_batch()
    cfg = Config(n_classes=17, n_filters=args.n_filters)
    model = seeded_model(cfg).to(dev)
    predict = make_predict_core(cfg, folded=fold_params(model, dev),
                                bf16=True, img_slots=img_slot_cap(batch_np),
                                detections_only=True)
    batch = to_device(batch_np, dev)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    predict(batch)
    sync()
    os.makedirs(args.out, exist_ok=True)
    _build.reset_launch_counts()
    with trace(args.out, dev):
        time.sleep(MARGIN)
        out = predict(batch)
        sync()
        time.sleep(MARGIN)
    launches = {k: v for k, v in _build.launch_counts.items() if v}
    found = glob.glob(os.path.join(args.out, "*.pt.trace.json"))
    if len(found) != 1:
        raise RuntimeError(f"{args.out} holds {len(found)} traces; give it "
                           "a directory without one")
    path = found[0]
    records, cpu_ops = kernel_records(path)
    records = {k: v for k, v in records.items() if v}
    if set(launches) - set(KERNELS):
        raise RuntimeError("launches of wrappers without a kernel name here: "
                           f"{sorted(set(launches) - set(KERNELS))}")
    if records != launches or (cuda and not launches):
        raise RuntimeError(
            f"the trace holds the kernel records {records} for the launches "
            f"{launches}: the profiler dropped records")
    res = {"trace": path, "launches": launches, "records": records,
           "cpu_ops": cpu_ops, "detections": int(out["valid"].sum())}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()

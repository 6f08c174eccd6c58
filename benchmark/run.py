"""Run one cell of the port's benchmark once and print its result line.

  python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for (`BENCHMARK.json`); without them it exits with 2 and prints no result.
Set-up (from the end of PyTorch's own import to the window's start): the
port's import; the corpus, written from the mix under a fresh directory
of TMPDIR; the weights, made on the card from
the seed; the port's loader (cold loads on the host library, built into
build/ on first use), model, optimizer, kernel library (built into build/
on first use) and train step; the first `CHECK_STEPS` steps (the eager
first step, the capture, replays), which the check reads. Then the window:
the train step loop for `--seconds`. With `--trace 1` the loop runs
`trace_steps` more steps under torch.profiler after the window. Then the
program's state is freed and the reference decides `correct`.

The last line of standard output is one JSON object: correct, attempted
(steps run), failed (steps whose loss was not finite), metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer ones), device,
breakdown (--trace 1) and checks (each number compared, with its limit;
also the last lines of standard error).
"""

from __future__ import annotations

import time

# set-up's clock starts once PyTorch itself is imported: its import reads
# the machine's file cache, warm or cold, and no change to the program
# moves it (its seconds are printed beside set-up's phases)
T_IMPORT = time.perf_counter()
import torch  # noqa: E402, F401
T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "yolat_tpu")
CHECK_STEPS = 3    # the first steps, which the reference follows
# one host thread for PyTorch's CPU ops (the staging copies): with one per
# core they stall now and then on a shared host (PERF.md, section 6)
HOST_THREADS = 1


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _traced(loop, n_steps: int):
    """Run n_steps under torch.profiler -> the trace part of the record."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace
    from yolat_tpu_torch.ops import _build

    before = dict(_build.launch_counts)
    loop.spans = record_function
    loop.step_rows = []
    acts = [ProfilerActivity.CPU]
    if loop.prog.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("bench.traced"):
            steps0 = loop.steps
            loop.run(n_steps=n_steps)
            steps = loop.steps - steps0
    loop.spans = None
    rows, loop.step_rows = loop.step_rows, None
    dev, host = trace.records(prof)
    lo, hi = trace.span(host, "bench.traced")
    return {"lo": lo, "hi": hi, "steps": steps, "dev": dev, "host": host,
            "rows": rows,
            "launches": {k: v - before[k]
                         for k, v in _build.launch_counts.items()}}


class Setup:
    """The program set up for one cell and seed, its first `CHECK_STEPS`
    steps run through the window's own call and feed, and what the check
    reads of them: `snap` (the program's losses, first and last gradients
    and parameters after them), `seen_gt` (each checked batch's ground truth),
    `files` (the corpus) and `weights` (the starting weights)."""

    def __init__(self, cell, seed: int, device, tmp: str):
        import torch

        from benchmark import corpus
        from benchmark.harness import Program, TrainLoop

        mix, cfg, ref = cell.mix, cell.config, cell.reference
        ref.check_config(cfg)
        torch.set_num_threads(HOST_THREADS)
        self.phases = {}
        t0 = time.perf_counter()
        c = mix["corpus"]
        self.files = corpus.write_corpus(
            tmp, c["n_files"], c["seed"], c["width"], c["height"],
            c["n_rooms"], tuple(c["symbols_per_room"]))
        self.weights = ref.make_weights(cfg, seed, device)
        t1 = time.perf_counter()
        self.prog = prog = Program(cell, seed, tmp, self.weights, device)
        self.loop = loop = TrainLoop(prog, ref.products(cfg))
        t2 = time.perf_counter()
        self.phases.update(corpus_and_weights=t1 - t0, program=t2 - t1,
                           **prog.phases)
        n_check = CHECK_STEPS
        self.seen_gt: list = []
        self.snap: dict = {}

        def on_batch(b):
            if len(self.seen_gt) < n_check:
                self.seen_gt.append((b["gt_bbox"].copy(),
                                     b["gt_labels"].copy(),
                                     b["gt_mask"].copy(), int(b["n_images"])))

        beta1 = prog.optimizer.param_groups[0]["betas"][0]
        moments = {}

        def after_step(i):
            named = dict(prog.model.named_parameters())
            if i >= n_check - 1 or i == 1:
                # a step that left no first moment read as a zero gradient
                moments[i] = {k: prog.optimizer.state[p].get(
                    "exp_avg", torch.zeros_like(p)).detach().clone()
                    for k, p in named.items()}
            if i == 1:
                self.snap["grad1"] = {k: m / (1.0 - beta1)
                                      for k, m in moments[1].items()}
            if i == n_check:
                # the last checked step is a graph replay: its gradient
                # as Adam read it, from the first moment before and after
                m0, m1 = moments[n_check - 1], moments[n_check]
                self.snap["grad_last"] = {
                    k: (m1[k] - beta1 * m0[k]) / (1.0 - beta1) for k in m1}
                self.snap["params"] = {k: p.detach().clone()
                                       for k, p in named.items()}

        loop.on_batch = on_batch
        loop.run(n_steps=n_check, after_step=after_step)
        loop.on_batch = None
        self.snap["losses"] = loop.losses[:n_check]
        self.phases["checked_steps"] = time.perf_counter() - t2

    def free(self) -> None:
        """Let the loader finish its epoch and drop the program's state."""
        import torch

        from benchmark.harness import sync

        device = self.prog.device
        self.loop.close()
        sync(device)
        self.prog = self.loop = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_inputs(self, cell, seed: int, device) -> list:
        """The reference's batches of this set-up's checked steps."""
        from benchmark import check

        return check.reference_inputs(cell, seed, self.files, self.seen_gt,
                                      device)


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device="cuda",
             t_start: float = T_START) -> dict:
    """One run of `cell` -> the result line's object."""
    import torch

    from benchmark import check
    from benchmark.manifest import metric_reader

    device = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="yolat_bench_")
    try:
        before = time.perf_counter() - t_start
        st = Setup(cell, seed, device, tmp)
        st.phases = {"torch_import": T_START - T_IMPORT, "start": before,
                     **st.phases}
        loop, prog = st.loop, st.prog
        setup_steps = loop.steps

        # the window
        from yolat_tpu_torch.ops import _build

        loop.reset()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        captured0 = _build.graph_counts["captured"]
        setup_s = time.perf_counter() - t_start
        window_s = loop.run(seconds=seconds)
        rec = {"cell": cell.name, "config": cell.config, "mix": cell.mix,
               "setup_s": setup_s, "steps": loop.steps,
               "images": loop.images, "window_s": window_s,
               "wait_s": loop.wait_s,
               "real": dict(loop.real), "padded": dict(loop.padded),
               "flops": loop.flops,
               "graph_captures": _build.graph_counts["captured"] - captured0,
               "trace": None}
        rec["peak_reserved_bytes"] = (torch.cuda.max_memory_reserved(device)
                                      if device.type == "cuda" else None)
        attempted = setup_steps + loop.steps
        if trace_on:
            rec["trace"] = _traced(loop, cell.mix["trace_steps"])
            attempted += rec["trace"]["steps"]
        failed = sum(not math.isfinite(v) for v in loop.losses)
        peak = (torch.cuda.max_memory_reserved(device)
                if device.type == "cuda" else 0)
        kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")

        # the program's state is freed before the reference runs
        st.free()
        loop = prog = None
        t_ref = time.perf_counter()
        try:
            ref = check.run_reference(
                cell, st.reference_inputs(cell, seed, device), st.weights)
            values = check.readings(st.snap, ref, st.weights)
        except check.Unmatched as e:  # the program packed a file not ours
            print(f"check: {e}", file=sys.stderr)
            values = dict.fromkeys(check.NUMBERS, math.inf)
        print(f"reference: {time.perf_counter() - t_ref:.1f} s; window "
              f"{window_s:.1f} s, {rec['steps']} steps; set-up {setup_s:.1f} "
              "s: " + ", ".join(f"{k} {v:.1f}" for k, v in st.phases.items()),
              file=sys.stderr)
        limits = cell.config["limits"]
        correct = check.judge(values, limits) and failed == 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    metrics = {}
    for m in cell.per_layer if trace_on else cell.end_to_end:
        v = metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace_on:
        from benchmark import trace

        t = rec["trace"]
        busy = trace.busy_ns([(s, e) for _, s, e in t["dev"]], t["lo"],
                             t["hi"])
        dev.update(busy_s=busy / 1e9, window_s=(t["hi"] - t["lo"]) / 1e9)
        out["breakdown"] = {
            "device_ops": trace.top_ops(t["dev"], t["lo"], t["hi"]),
            "idle_gaps": trace.named_gaps(t["dev"], t["host"], t["lo"],
                                          t["hi"])}
    out["checks"] = {k: {"value": values[k], "limit": limits[k]}
                     for k in check.NUMBERS}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.manifest import load_cell

    cell = load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (the benchmark "
              "runs the port alone)", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())

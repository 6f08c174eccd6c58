"""How often a torch.profiler profile drops records of the calls it covers,
by the host-time margin that `source_edits._records` keeps before the first
call and after the last, and how far a record's time, taken on the card,
falls outside the host's span of its call.

  python -m yolat_tpu_torch.scripts.profiler_records [--seconds 150]
      [--reps 40] [--seed 0]

On the card. The calls are kernel 9's forward (`ops.edge_window_train.
pair_fwd`, bf16, C = 64) and its library call (two `index_select`) on the
bench batch's sizes (N = 72704 nodes, E = 46102 edges sorted by
destination, drawn from `--seed`), each profiled as `source_edits._records`
profiles it (`--reps` calls), with and without an L2 flush before every
call (a 128 MB device-to-device copy, `profiled_calls.l2_flush`), with a
margin of 0, 0.01 or 0.05 s. The twelve arms take turns until `--seconds`
have passed. Each call here ends with a synchronise, so that the host
brackets it: its time just before the launch and just after the
synchronise returns.

For every profile it counts the records that its calls should leave (the
kernels of a reference profile of one call, `reps` times, and one copy per
flush) against those it holds. For every kept kernel record it reads the
record's start and end (converted by the profiler onto the host's wall
clock) against its call's bracket: on one clock a record starts after the
launch and ends before the synchronise returns, so a start before the
bracket ("early") or an end after it ("late") is the conversion's error.

Prints one JSON line per arm: profiles, profiles that dropped a record,
the kernel records and flush copies dropped, the kept records that fall
early and late, the most early and the most late (µs); then a line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import time


MARGINS = (0.0, 0.01, 0.05)


def _calls(args):
    import torch

    from yolat_tpu_torch.ops import edge_window_train as ewt
    from yolat_tpu_torch.scripts import profiled_calls, source_edits

    n, e, c = 72704, 46102, 64
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn(n, c, device="cuda", generator=gen).to(torch.bfloat16)
    dst = torch.randint(0, n, (e,), device="cuda", generator=gen).sort().values
    src = torch.randint(0, n, (e,), device="cuda", generator=gen)
    dst, src = dst.int(), src.int()
    dstl, srcl = dst.long(), src.long()
    flush = profiled_calls.l2_flush("cuda")
    fns = {"kernel": lambda: ewt.pair_fwd(x, src, dst),
           "library": lambda: (x.index_select(0, dstl),
                               x.index_select(0, srcl))}
    for f in fns.values():
        for _ in range(3):
            f()
    torch.cuda.synchronize()
    ref = {}
    for k, f in fns.items():
        got = source_edits._records(f, 1)[0]
        ref[k] = {name: c for name, (_, c) in got.items()}
    return fns, flush, ref


def _one(fn, per_call, reps, flush, margin):
    """One profile: (kernel records dropped, flush copies dropped, the kept
    kernel records' errors in µs: [early, ...] and [late, ...], each > 0)."""
    import torch

    from yolat_tpu_torch.scripts import source_edits

    spans = []

    def bracketed():
        t0 = time.time_ns()
        fn()
        torch.cuda.synchronize()
        spans.append((t0, time.time_ns()))

    got, copies, prof = source_edits._records(bracketed, reps, flush, margin)
    dropped = sum(per_call.values()) * reps - sum(c for _, c in got.values())
    copies_dropped = (reps if flush else 0) - copies
    early, late = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA \
                or ev.name().startswith(source_edits.COPY_RECORD):
            continue
        t0, t1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        # the call whose bracket holds the record, or the nearest one
        i = min(range(len(spans)), key=lambda j: max(
            spans[j][0] - t0, t1 - spans[j][1], 0))
        if t0 < spans[i][0]:
            early.append((spans[i][0] - t0) / 1e3)
        if t1 > spans[i][1]:
            late.append((t1 - spans[i][1]) / 1e3)
    return dropped, copies_dropped, early, late


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=150.0)
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    fns, flush, ref = _calls(args)
    arms = list(itertools.product(fns, (False, True), MARGINS))
    res = {a: dict(profiles=0, dropped_profiles=0, kernel_records_dropped=0,
                   flush_copies_dropped=0, early_records=0, late_records=0,
                   most_early_us=0.0, most_late_us=0.0) for a in arms}
    t_end = time.time() + args.seconds
    while time.time() < t_end:
        for a in arms:
            name, flushed, margin = a
            d, cd, early, late = _one(fns[name], ref[name], args.reps,
                                      flush if flushed else None, margin)
            r = res[a]
            r["profiles"] += 1
            r["dropped_profiles"] += int(d != 0 or cd != 0)
            r["kernel_records_dropped"] += d
            r["flush_copies_dropped"] += cd
            r["early_records"] += len(early)
            r["late_records"] += len(late)
            r["most_early_us"] = max([r["most_early_us"]] + early)
            r["most_late_us"] = max([r["most_late_us"]] + late)
    out = []
    for (name, flushed, margin), r in res.items():
        line = dict(call=name, flush=flushed, margin_s=margin,
                    reps=args.reps, **r)
        print(json.dumps(line), flush=True)
        out.append(line)
    dev = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": dev}))
    return out


if __name__ == "__main__":
    main()

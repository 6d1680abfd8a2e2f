"""Two modes of ``run.py`` outside the run contract, each in one process.

``--sweep RATES [--schedules SEEDS]``: the knee of an open-loop cell.
One set-up, then for each schedule (the traffic file's ``schedule_seed``
unless given) and each arrival rate an open-loop window of ``--seconds``
at that rate, its requests followed to their end and drained; printed
per step: the p50 and p90 of TTFT and the p90 of JCT over the requests
due in the window, the requests waiting for their first token at the
window's close, how many were due, and the most KV each engine held.
The highest rate at which the wait stays bounded on every schedule is
the knee; the cell's rate is written as a number into its traffic file.

``--calibrate SEEDS``: the readings a cell's limits are set from.  For
each seed, a whole run at ``--seconds`` (set-up, traffic, the program
freed), then the reference's judgement of the run's sample and the fp8
control's reading of the same sample.  One JSON line per seed.
"""
from __future__ import annotations

import json
import time

import torch

from omnibench import harness, judge, probes, spec, stats
from omnibench.traffic import Traffic


def _cell(args):
    bench = spec.load_benchmark()
    spec.validate(bench)
    cell = spec.cell(bench, args.workload)
    info = harness.card(cell.chips)
    harness.log(f"card: {info['kind']} x{info['count']}, power limit {info['power_limit']}")
    return cell, info


def sweep(args, t_start: float) -> None:
    cell, info = _cell(args)
    if cell.traffic["loop"] != "open":
        raise harness.RunError("--sweep needs an open-loop cell")
    model, serve = dict(cell.config["model"]), dict(cell.config["serve"])
    sys_ = harness.build(cell, args.seed, "cuda", model, serve)
    rec = probes.Recorder(sys_.graph_mod.OUTPUT_STAGE, True)
    rec.watch_tokens(sys_.orch)
    sender = harness.Sender(sys_, rec)
    slot = harness._ProfileSlot(None, args.seconds)
    schedules = ([int(x) for x in args.schedules.split(",")] if args.schedules
                 else [int(cell.traffic["schedule_seed"])])
    try:
        sys_.orch.start()
        harness.warm_up(sys_, sender, args.seed, model["vocab_size"])
        harness.log(f"set-up {time.perf_counter() - t_start:.3f} s")
        for schedule in schedules:
            for rate in [float(x) for x in args.sweep.split(",")]:
                print(json.dumps(_sweep_step(cell, sys_, sender, slot, model, args, rate,
                                             schedule, info)), flush=True)
    finally:
        sys_.orch.shutdown(drain=False)


def _sweep_step(cell, sys_, sender, slot, model, args, rate, schedule, info) -> dict:
    """One rate on one schedule: its window served and followed to the end,
    then every request drained before the next step."""
    sender.records.clear()
    sender.kv = probes.KvPeak(sys_.engines)
    traffic = Traffic({**cell.traffic, "rate_per_s": rate, "schedule_seed": schedule},
                      model["vocab_size"], args.seed, args.seconds)
    w = harness.drive_open(sys_, sender, traffic, args.seconds,
                           float(cell.traffic.get("grace_s", 60.0)), slot)
    sender.collect()
    recs = list(sender.records.values())
    counted = [r for r in recs if r.counted]
    # sent by the close and still without a first token then: the queue
    # in front of prefill, which grows without bound past the knee
    waiting = sum(1 for r in recs if r.sent <= w.t_close
                  and not (r.stamps and r.stamps[0][0] <= w.t_close))
    unfinished = sum(1 for r in counted if not r.done or r.failed)
    while not all(r.done for r in recs):           # drain before the next step
        harness._check_alive(sys_)
        time.sleep(0.05)
    ttft = [(r.stamps[0][0] - r.due) if r.stamps and r.done and not r.failed
            else float("inf") for r in counted]
    jct = [(r.stamps[-1][0] - r.due) if r.stamps and r.done and not r.failed
           else float("inf") for r in counted]
    return {"rate_per_s": rate, "schedule_seed": schedule, "due": len(counted),
            "unfinished_after_grace": unfinished, "ttft_p50_s": stats.pct(ttft, 50),
            "ttft_p90_s": stats.pct(ttft, 90), "jct_p90_s": stats.pct(jct, 90),
            "waiting_at_close": waiting, "kv_held": sender.kv.summary(),
            "card": info["kind"], "power_limit": info["power_limit"]}


def calibrate(args, t_start: float) -> None:
    cell, info = _cell(args)
    for seed in [int(x) for x in args.calibrate.split(",")]:
        t0 = time.perf_counter()
        model, serve = dict(cell.config["model"]), dict(cell.config["serve"])
        sys_, measured = harness.serve_cell(cell, seed, args.seconds, False, "cuda", t0,
                                            model, serve)
        harness.free(sys_)
        picked = judge.sample(measured.records, seed)
        g = judge.gaps(cell.family, model, seed, picked, "cuda", control=True)
        finished = [r for r in measured.counted if r.done and not r.failed]
        row = {"seed": seed, "program": judge.statistics(g["program"]),
               "control": judge.statistics(g["control"]),
               "program_per_request": [float(x.max()) for x in g["program"]],
               "control_per_request": [float(x.max()) for x in g["control"]],
               "program_mean_per_request": [float(x.mean()) for x in g["program"]],
               "served_per_request": [len(x) for x in g["program"]],
               "sampled_tokens": int(sum(len(x) for x in g["program"])),
               "short_answers": sum(1 for r in finished if len(r.served()) != r.out_len),
               "moe_dropped_pairs": measured.moe_drops, "counted": len(measured.counted),
               "setup_s": measured.setup_s, "card": info["kind"],
               "power_limit": info["power_limit"]}
        print(json.dumps(row), flush=True)
        del measured
        torch.cuda.empty_cache()

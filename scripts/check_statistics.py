"""How often each candidate statistic of `chip_smoke.py`'s card-against-CPU
train-step check would refuse a correct program, estimated from recorded
per-batch readings.

Input: the `--raw` files of `scripts/torch_check_spread.py` (one per
phase: for each trained run, every batch's squared gradient distances of
the card and of the CPU's bf16 step to the CPU's f32 step, and the three
steps' loss parts, as `chip_smoke.grad_errors` returns them). For each
phase it prints the distribution of the per-batch gradient ratio
(card / CPU bf16 distance to f32) and of each loss part's rel error
(card vs CPU bf16): median, 90th percentile and maximum. Then it draws
`--draws` calls by resampling: a run at random, then `--batches` of its
batches at random (with replacement), and counts how often each
statistic exceeds its bound in one call:

- `pooled ratio` (the earlier statistic): sqrt(sum card / sum cpu) > 1.5;
- `median ratio`: the median of the per-batch ratios > 1.5;
- `first-batch parts` (earlier): any loss part of the first batch with
  rel error > 5e-2 (and an absolute difference > 1e-9);
- `pooled parts`: any part's summed absolute difference over the summed
  absolute CPU values > 5e-2.

It runs on the CPU on recorded numbers and measures nothing on a device.

    python3 scripts/check_statistics.py spread_13.json spread_4.json \\
        [--batches 16] [--draws 20000]
"""

from __future__ import annotations

import argparse
import json
import math
import random
import statistics
from typing import Dict, List

RATIO_BOUND = 1.5
PART_BOUND = 5e-2


def ratio(e: dict) -> float:
    return math.sqrt(e["card"] / e["cpu"]) if e["cpu"] else 0.0


def part_err(e: dict, k: str) -> float:
    card, cpu, _ = e["parts"]
    return abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12)


def pooled_ratio(es: List[dict]) -> float:
    return math.sqrt(sum(e["card"] for e in es) / sum(e["cpu"] for e in es))


def median_ratio(es: List[dict]) -> float:
    return statistics.median(ratio(e) for e in es)


def pooled_parts(es: List[dict]) -> Dict[str, float]:
    out = {}
    for k in es[0]["parts"][1]:
        diff = sum(abs(e["parts"][0][k] - e["parts"][1][k]) for e in es)
        out[k] = diff / max(sum(abs(e["parts"][1][k]) for e in es), 1e-30)
    return out


def first_parts_trip(e: dict) -> bool:
    card, cpu, _ = e["parts"]
    return any(part_err(e, k) > PART_BOUND and abs(card[k] - cpu[k]) > 1e-9
               for k in cpu)


def quantiles(xs: List[float]) -> str:
    xs = sorted(xs)
    p90 = xs[min(len(xs) - 1, int(math.ceil(0.9 * len(xs))) - 1)]
    return (f"median {statistics.median(xs):.3e}, p90 {p90:.3e}, "
            f"max {xs[-1]:.3e} (n={len(xs)})")


STATS = {
    "pooled ratio": lambda es: pooled_ratio(es) > RATIO_BOUND,
    "median ratio": lambda es: median_ratio(es) > RATIO_BOUND,
    "first-batch parts": lambda es: first_parts_trip(es[0]),
    "pooled parts": lambda es: max(pooled_parts(es).values()) > PART_BOUND,
}


def summarize(name: str, runs: List[List[dict]], batches: int, draws: int,
              rng: random.Random) -> Dict[str, float]:
    flat = [e for run in runs for e in run]
    print(f"[stats] {name}: {len(runs)} runs x "
          f"{', '.join(str(len(r)) for r in runs)} batches")
    print(f"[stats] {name} per-batch gradient ratio: "
          + quantiles([ratio(e) for e in flat]))
    for k in flat[0]["parts"][1]:
        print(f"[stats] {name} per-batch {k} rel error: "
              + quantiles([part_err(e, k) for e in flat]))
    for i, run in enumerate(runs):
        print(f"[stats] {name} run {i}: pooled ratio {pooled_ratio(run):.3f}"
              f", median ratio {median_ratio(run):.3f}, first {batches} "
              f"batches pooled {pooled_ratio(run[:batches]):.3f} / median "
              f"{median_ratio(run[:batches]):.3f}; pooled parts "
              + " ".join(f"{k} {v:.2e}" for k, v in
                         pooled_parts(run[:batches]).items()))
    trips = dict.fromkeys(STATS, 0)
    for _ in range(draws):
        run = runs[rng.randrange(len(runs))]
        es = [run[rng.randrange(len(run))] for _ in range(batches)]
        for s, fn in STATS.items():
            trips[s] += fn(es)
    rates = {s: n / draws for s, n in trips.items()}
    print(f"[stats] {name}: estimated refusals per call over {draws} "
          f"resampled calls of {batches} batches: "
          + ", ".join(f"{s} {r:.4%}" for s, r in rates.items()),
          flush=True)
    return rates


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("raw", nargs="+")
    parser.add_argument("--batches", type=int, default=16)
    parser.add_argument("--draws", type=int, default=20000)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    rng = random.Random(args.seed)
    out = {}
    for path in args.raw:
        with open(path) as fp:
            rec = json.load(fp)
        print(f"[stats] {path}: card {rec['card']}")
        for phase, runs in rec["runs"].items():
            name = f"{path.rsplit('/', 1)[-1]} phase {phase}"
            out[name] = summarize(name, runs, args.batches, args.draws, rng)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

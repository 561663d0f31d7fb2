"""The spread of `chip_smoke.py`'s card-against-CPU train-step checks over
many batches and several sets of trained weights, on one card.

`chip_smoke.py` holds one train step on the card against the same step
on the CPU (`check_train_step_against_cpu`) over 16 batches of 64 rays:
every loss part pooled over them within 5e-2, and the median over them
of the per-batch ratio of the card's bf16 gradient distance to the f32
gradient over the CPU's bf16 one within 1.5 (earlier: the first
batch's parts, and the ratio of the distances pooled over the batches).
Both are draws: a batch's distance is set by its few worst rays, and the
trained weights differ between runs. This script measures those draws
for the checks' phase: it trains `--runs` times the phase's `--steps`
steps through the train entry point on `chip_smoke.py`'s synthetic
scene (run r with the config's `seed` 4 + r, so each run draws its own
batches and ends at its own weights), then, for each run, `--batches`
batches (seeds 5, 6, ...): per batch every loss part's rel error card
against CPU bf16 and the ratio of the card's to the CPU's gradient
distance to f32, and per run the pooled ratio of the first 16 and of all
batches. One line per batch, the card's name and power limit, and a
JSON summary last; with `--raw FILE` also every batch's squared
gradient distances and loss parts (card, CPU bf16, CPU f32) as
`chip_smoke.grad_errors` returns them, for resampling the checks'
statistics off the card (`scripts/check_statistics.py`).

    python3 scripts/torch_check_spread.py [--phase 13] [--runs 2] \\
        [--batches 32] [--raw spread.json]

`--phase` is 4 (`configs/panonerf.yaml`), 4b (the same with
`nerf.use_train_render_kernel`) or one of `chip_smoke.STUDY_PHASES`;
several, comma-separated, run one after the other.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def phase_run(phase: str):
    """(overrides, key on?) of a `chip_smoke.py` train phase."""
    import chip_smoke
    if phase in ("4", "4b"):
        return (), phase == "4b"
    opts, k5, _ = chip_smoke.STUDY_PHASES[int(phase)]
    return opts, k5


def spread(trainer, batches: int) -> dict:
    """Per batch: each loss part's rel error card vs CPU bf16 and the
    gradient ratio; pooled ratios over the first 16 and all batches."""
    import chip_smoke
    errs = chip_smoke.grad_errors(trainer, range(5, 5 + batches))
    rows = []
    for i, e in enumerate(errs):
        card, cpu, _ = e["parts"]
        parts = {k: abs(card[k] - v) / max(abs(v), 1e-12)
                 for k, v in cpu.items()}
        ratio = math.sqrt(e["card"] / e["cpu"]) if e["cpu"] else 0.0
        rows.append(dict(seed=5 + i, parts=parts, grad_ratio=ratio))

    def pooled(es):
        return math.sqrt(sum(e["card"] for e in es)
                         / sum(e["cpu"] for e in es))
    return dict(batches=rows, pooled_16=pooled(errs[:16]),
                pooled_all=pooled(errs), raw=errs)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phase", default="13")
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--batches", type=int, default=32)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--raw", default="")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the spread is measured on the card",
              file=sys.stderr)
        return 2
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"[card] {card}", flush=True)
    chip_smoke.build_kernels()
    summary = dict(card=card, phases={})
    raw = {}
    with tempfile.TemporaryDirectory() as workdir:
        scene = chip_smoke.make_scene(workdir)
        for phase in args.phase.split(","):
            opts, k5 = phase_run(phase)
            summary["phases"][phase] = runs = []
            raw[phase] = []
            for r in range(args.runs):
                # Each run its own data stream (the trainer's generator
                # is seeded from `seed`), so its own trained weights.
                run = chip_smoke.drive_train_path(
                    workdir, scene, render_kernel=k5,
                    opts=opts + ("seed", str(4 + r)), steps=args.steps,
                    name=f"spread{phase}_{r}")
                res = spread(run["trainer"], args.batches)
                del run["trainer"]
                for b in res["batches"]:
                    print(f"[spread] phase {phase} run {r} seed "
                          f"{b['seed']}: grad ratio {b['grad_ratio']:.3f}; "
                          "loss parts rel " + " ".join(
                              f"{k} {v:.2e}" for k, v in b["parts"].items()),
                          flush=True)
                print(f"[spread] phase {phase} run {r}: pooled ratio "
                      f"{res['pooled_16']:.3f} over the first 16 batches, "
                      f"{res['pooled_all']:.3f} over {args.batches}",
                      flush=True)
                raw[phase].append(res.pop("raw"))
                runs.append(res)
                torch.cuda.empty_cache()
                if args.raw:
                    os.makedirs(os.path.dirname(args.raw) or ".",
                                exist_ok=True)
                    with open(args.raw, "w") as fp:
                        json.dump(dict(card=card, runs=raw), fp)
    print(f"[card] {card}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

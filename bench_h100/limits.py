#!/usr/bin/env python3
"""Readings that a cell's limits are set from.

    python bench_h100/limits.py --workload attn64-train-b4x8 \\
        --seeds 1,2,...,12 --control-seeds 1,2,3

Per seed it prints one JSON line of the numbers ``correct`` compares,
for the program (the lower reading is the largest over a dozen seeds or
more) and, on the control seeds, for the control: the reference put in
the program's place and computed in float8, the precision below the
configuration's bfloat16 (the upper reading is the smallest over those
seeds), and for the reference with half of each microbatch left out.
Each seed runs the cell's correctness steps only, with no window.
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from bench_h100.common import card_line, log, make_context, set_cache_dirs  # noqa: E402


def main(argv=None, device: str = 'cuda') -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--control-seeds', default='')
    args = p.parse_args(argv)
    if device == 'cuda':
        log(f'card: {card_line()}')
    set_cache_dirs()
    controls = {int(s) for s in args.control_seeds.split(',') if s}
    for seed in (int(s) for s in args.seeds.split(',')):
        ctx = make_context(args.workload, seed, 0, device=device)
        try:
            from bench_h100.drivers import train
            r = train.drive(ctx, window=False)
            out = (train.judge(ctx, r, control=True) if seed in controls
                   else {'program': train.judge(ctx, r)})
        finally:
            shutil.rmtree(ctx.tmp, ignore_errors=True)
        for kind, nums in out.items():
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'kind': kind, **nums}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's file ``workloads/<cell>.json`` names its configuration, its
traffic and its chips; the traffic names the driver that runs it. The
run sets up (weights from the seed, the program loaded and warmed up),
measures for ``--seconds``, checks what the measured path produced
against the plain reference, and prints as its last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``compared``: each number that decided ``correct`` beside its limit.

It exits non-zero and prints no result when CUDA is absent or has fewer
cards than the cell asks for, when the program cannot be imported, and
when JAX or the JAX package was loaded by the time the window closed.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# import the benchmark as a package from the checkout's root, and keep
# this folder's module names off the path
sys.path[0] = str(HERE.parent)

from bench_h100.common import (card_line, forbidden_modules,  # noqa: E402
                               load_named, log, make_context, set_cache_dirs)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') this cell
    reports: those that list it, and those without a list."""
    return [m for m in bench.get(kind, [])
            if workload in m.get('workloads', [workload])]


def read_layer_metric(root: Path, name: str, layer: dict, trace):
    path = root / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        'bench_h100_metric_' + name.replace('.', '_').replace('-', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(layer, trace)


def main(argv=None, device: str = 'cuda', look_for_chip: bool = True,
         root: Path = HERE) -> int:
    """Run the cell; returns the exit code. Tests pass ``device='cpu'``,
    ``look_for_chip=False`` and a ``root`` holding their own cells."""
    args = parse_args(argv)
    bench_path = root.parent / 'BENCHMARK.json'
    bench = json.loads(bench_path.read_text())
    cell = load_named('workloads', args.workload, root)
    listed = {w['name']: w for w in bench['workloads']}.get(args.workload)
    if listed is not None and any(listed[k] != cell[k] for k in
                                  ('config', 'traffic', 'chips')):
        log(f'{args.workload}: BENCHMARK.json and workloads/'
            f'{args.workload}.json disagree')
        return 2
    import torch
    if look_for_chip:
        if not torch.cuda.is_available():
            log('no CUDA device: the benchmark measures the card only')
            return 3
        if torch.cuda.device_count() < cell['chips']:
            log(f"{args.workload} needs {cell['chips']} cards, "
                f'{torch.cuda.device_count()} visible')
            return 3
        log(f'card: {card_line()}')
    set_cache_dirs(root.parent)
    ctx = make_context(args.workload, args.seed, args.seconds,
                       bool(args.trace), device, root, T0)
    traffic = ctx.traffic
    driver = importlib.import_module(f"bench_h100.drivers.{traffic['driver']}")
    try:
        out = driver.run(ctx)
    finally:
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    loaded = forbidden_modules()
    if loaded:
        log(f'the run loaded {", ".join(loaded)}: refused')
        return 4
    metrics = {}
    if args.trace:
        for m in cell_metrics(bench, args.workload, 'per_layer'):
            value = read_layer_metric(root, m['name'], out.layer, out.trace)
            if value is None:
                log(f"{m['name']}: nothing to read in this run")
                continue
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        for m in cell_metrics(bench, args.workload, 'end_to_end'):
            if m['name'] not in out.end_to_end:
                log(f"{m['name']}: the {traffic['driver']} driver does not "
                    'measure it')
                return 5
            metrics[m['name']] = {'value': out.end_to_end[m['name']],
                                  'unit': m['unit']}
    dev = {'platform': 'gpu' if device == 'cuda' else device,
           'kind': out.device_kind, 'count': out.device_count,
           'memory_peak_bytes': out.memory_peak_bytes}
    result = {'correct': out.correct, 'attempted': out.attempted,
              'failed': out.failed, 'metrics': metrics, 'device': dev}
    if args.trace and out.trace is not None:
        dev['busy_s'] = out.trace.busy_s
        dev['window_s'] = out.trace.window_s
        result['breakdown'] = out.trace.breakdown()
    result['compared'] = out.compared
    for name, c in out.compared.items():
        log(f"compared {name}: {c['value']!r} (limit {c['limit']!r})")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    os.environ.setdefault('USE_FLAX', '0')
    sys.exit(main())

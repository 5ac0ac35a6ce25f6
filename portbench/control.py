"""The controls of the comparisons that decide `correct`, at a cell's
own size, and the faults a training cell's numbers are held against.
Not run by the benchmark's runs: its readings set the upper end of each
limit (PERF.md gives them).

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

A merge sweep's control is the program's own lower-precision path: the
contributions compressed to int8 payloads (`compress_tree`, one scale a
leaf) and merged through `engine.merge(..., kernels=True)` (B2 for task
arithmetic, the int8 slices dequantized for TIES), `requests` requests
of the seed's stream, each compared with the reference over the bf16
contributions as a run compares. A training cell's control is the
reference with its products' operands in float8 e4m3 (the program has
no such path), and its faults are the reference over half of each batch
("half") and with one leaf's update left out ("frozen"); a state left
unchanged reads 1 on `update_gap` by the measure and needs no run. Each
prints one JSON line {"cell", "seed", "what", "checks"}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from portbench import checks, common, gen, registry  # noqa: E402
from portbench.reference import layout as L  # noqa: E402
from portbench.reference import merge as refmerge  # noqa: E402
from portbench.reference import train as reftrain  # noqa: E402


def merge_control(cell, seed: int, device, requests: int = 8) -> dict:
    """The program's int8 path in the program's place."""
    from portbench.drivers import merge_sweep
    from repro_torch.api import MergeSpec
    from repro_torch.core import engine
    from repro_torch.core.compression import compress_tree, decompress_tree
    traffic = cell.traffic
    lay = L.layout(cell.config)
    base, contribs = gen.merge_inputs(lay, seed, traffic["contributions"],
                                      traffic["delta_scale"], torch.bfloat16,
                                      device)
    ids = [refmerge.tree_id({leaf.key: c[leaf.path] for leaf in lay})
           for c in contribs]
    order = sorted(range(len(ids)), key=lambda i: ids[i])
    cts = [compress_tree(L.nest(contribs[i])) for i in order]
    # the bf16 contributions wait on the host while the int8 path runs
    contribs = [{k: v.cpu() for k, v in c.items()} for c in contribs]
    common.free()
    q_ids = []
    for ct in cts:          # the int8 payloads' own content ids
        deq = decompress_tree(ct)
        q_ids.append(refmerge.tree_id({leaf.key: L.at(deq, leaf.path)
                                       for leaf in lay}))
        del deq
    q_root = refmerge.merkle_root(q_ids)
    common.free()
    g = torch.Generator().manual_seed(gen.sub_seed(seed, "columns"))
    cols = {leaf.path: refmerge.sample_columns(
        leaf.numel, traffic["sample_blocks"], traffic["sample_width"], g)
        .to(device) for leaf in lay}
    stream = gen.merge_requests(seed, traffic["mix"])
    done = []
    for _ in range(requests):
        req = next(stream)
        out = engine.merge(cts, spec=MergeSpec(req["strategy"], req["cfg"]),
                           contrib_ids=[f"int8-{i}" for i in order],
                           base=L.nest(base), seed=0, kernels=True,
                           use_cache=False)
        done.append({"req": req, "out": {
            leaf.path: L.at(out, leaf.path).reshape(-1)[cols[leaf.path]]
            for leaf in lay}})
        del out
    del cts
    common.free()
    contribs = [{k: v.to(device) for k, v in c.items()} for c in contribs]
    return merge_sweep._check(lay, base, contribs, cols, done, q_root)


def train_readings(cell, seed: int, device, what) -> list:
    from portbench.drivers.finetune import _opt, sample
    config, traffic = cell.config, cell.traffic
    lay = L.layout(config)
    b, s = traffic["batch"], traffic["seq_len"]
    batches = [gen.tokens(seed, i, b, s, config["vocab_size"], device)
               for i in range(1, traffic["check_steps"] + 1)]
    opt = _opt(config, traffic)
    idx = sample(lay, seed, traffic)
    ref = reftrain.run(config, lay, seed, batches, opt, device, idx)
    common.free()
    out = []
    for name in what:
        kw = {"precision": "fp8"} if name == "fp8" else {"fault": name}
        t0 = time.perf_counter()
        got = reftrain.run(config, lay, seed, batches, opt, device, idx,
                           **kw)
        common.free()
        out.append((name, checks.training(got, ref),
                    time.perf_counter() - t0))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--what", default="fp8,half,frozen",
                    help="training: the control and faults to read")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    cell = registry.cell(args.workload)
    for seed in args.seeds:
        if cell.traffic["kind"] == "merge_sweep":
            t0 = time.perf_counter()
            vals = merge_control(cell, seed, device, args.requests)
            rows = [("int8", vals, time.perf_counter() - t0)]
        else:
            rows = train_readings(cell, seed, device, args.what.split(","))
        for what, vals, secs in rows:
            print(json.dumps({"cell": cell.name, "seed": seed, "what": what,
                              "seconds": secs, "checks": vals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

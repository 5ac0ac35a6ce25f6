"""CLI: CRDT-merge trained checkpoints (`repro.launch.merge`).

  PYTHONPATH=src python -m repro_torch.launch.merge \
      --arch minitron-8b --smoke --strategy ties --device cpu \
      --inputs /tmp/ck_a/step_00000010 /tmp/ck_b/step_00000010 \
      --base /tmp/ck_base/step_00000000 --out /tmp/merged

Every input checkpoint becomes one OR-Set contribution; the resolve is
deterministic in the contribution SET (order and duplication of
--inputs are irrelevant by construction, the point of the paper).

Output goes through the `repro_torch.obs` structured event log, as the
reference's: the default verbosity prints the legacy lines, `--verbose`
the JSON events instead, `--quiet` nothing, and `--events-out FILE`
also dumps the event stream as JSONL. The reference's flags, plus
`--device` (CUDA unless another is named). The written checkpoint is
the reference's: the merged parameters, zero moments, step 0.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.api import MergeSpec, Replica
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.resolve import seed_from_root
from repro_torch.models.model import Model
from repro_torch.obs import EventLog
from repro_torch.optim.adamw import init_opt_state
from repro_torch.train.step import train_state_shapes


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--strategy", default="ties")
    ap.add_argument("--inputs", nargs="+", required=True)
    ap.add_argument("--base", default="",
                    help="base checkpoint for task-vector strategies")
    ap.add_argument("--out", required=True)
    ap.add_argument("--node", default="merge-cli")
    ap.add_argument("--state-dir", default="",
                    help="durable replica directory: contributions are "
                    "journaled (crash-safe) and a re-run resumes from "
                    "the recovered OR-Set instead of starting empty")
    vb = ap.add_mutually_exclusive_group()
    vb.add_argument("--quiet", action="store_true",
                    help="no stdout output")
    vb.add_argument("--verbose", action="store_true",
                    help="print structured JSON events instead of text")
    ap.add_argument("--events-out", default="",
                    help="also write the event stream to this JSONL file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    like = train_state_shapes(model)        # structure only

    replica = Replica(args.node, path=args.state_dir or None,
                      device=args.device)
    device = replica.device
    log = EventLog.from_args(args, registry=replica.obs)
    if args.state_dir and replica.visible():
        log.emit("state_recovered",
                 f"recovered {len(replica.visible())} contributions from "
                 f"{args.state_dir} "
                 f"(root {replica.merkle_root().hex()[:16]}…)",
                 state_dir=args.state_dir,
                 visible=len(replica.visible()),
                 root=replica.merkle_root().hex())
    for path in args.inputs:
        ckpt, meta = restore_checkpoint(path, like, device=device)
        eid = replica.contribute(ckpt["params"])
        del ckpt
        log.emit("contribution_added",
                 f"added {path} (data_step={meta.get('data_step')}) "
                 f"visible={len(replica.visible())}",
                 path=path, eid=eid,
                 data_step=meta.get("data_step"),
                 visible=len(replica.visible()))

    base = None
    if args.base:
        base_ckpt, _ = restore_checkpoint(args.base, like, device=device)
        base = base_ckpt["params"]
        del base_ckpt

    merged = replica.resolve(MergeSpec(args.strategy), base=base)
    root = replica.merkle_root()
    log.emit("resolved",
             f"resolved {len(replica.visible())} contributions with "
             f"{args.strategy} (root {root.hex()[:16]}…, "
             f"seed {seed_from_root(root)})",
             strategy=args.strategy, k=len(replica.visible()),
             root=root.hex(), seed=seed_from_root(root))

    out_state = dict(init_opt_state(merged, cfg.opt_state_dtype))
    out_state["params"] = merged
    out_state["step"] = torch.zeros((), dtype=torch.int32)
    path = save_checkpoint(args.out, out_state, 0,
                           metadata={"merged_from": args.inputs,
                                     "strategy": args.strategy,
                                     "merkle_root": root.hex(),
                                     "data_step": 0})
    log.emit("checkpoint_written",
             f"wrote merged checkpoint to {path}", path=str(path))
    replica.close()
    if args.events_out:
        log.dump(args.events_out)


if __name__ == "__main__":
    main()

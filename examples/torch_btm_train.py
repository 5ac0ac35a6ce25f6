"""End-to-end driver on the PyTorch port (the port of
`examples/btm_train.py`): decentralised Branch-Train-Merge with CRDT
merging.

Four branches fine-tune a reduced minicpm on four different synthetic
tasks; every `--merge-every` steps they contribute parameters, gossip,
and independently resolve the identical merged model. Demonstrates:
  * merged model improves on ALL tasks (multi-task transfer),
  * branch failure mid-run (--kill), straggler (--straggle), elastic
    join (--join) — training never stops.

  PYTHONPATH=src python examples/torch_btm_train.py
  PYTHONPATH=src python examples/torch_btm_train.py --device cpu \
      --rounds 2 --merge-every 3 --branches 2 --seq 32 --batch 4
  PYTHONPATH=src python examples/torch_btm_train.py --full   # ~100M model

Runs on CUDA unless `--device` names another device. The base model is
`Model.init(PRNGKey(0))`, the JAX package's parameters bit for bit.
"""
import argparse

from repro_torch.configs import smoke_config
from repro_torch.train.btm import BranchTrainMerge


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--merge-every", type=int, default=10)
    ap.add_argument("--branches", type=int, default=4)
    ap.add_argument("--strategy", default="weight_average")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--kill", type=int, default=-1,
                    help="kill this branch after round 2")
    ap.add_argument("--straggle", type=int, default=-1,
                    help="make this branch a 1-round straggler")
    ap.add_argument("--join", action="store_true",
                    help="elastically add a branch after round 3")
    ap.add_argument("--deltas", action="store_true",
                    help="delta-state gossip instead of full state")
    ap.add_argument("--full", action="store_true",
                    help="~100M-param config instead of smoke size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch).replace(grad_accum=1)
    if args.full:
        cfg = cfg.replace(d_model=512, n_layers=12, n_heads=8, n_kv_heads=8,
                          head_dim=64, d_ff=2048, vocab_size=32000,
                          attn_q_chunk=256)
    total, _ = cfg.param_counts()
    print(f"arch={cfg.name} params={total/1e6:.1f}M "
          f"branches={args.branches} strategy={args.strategy}")

    btm = BranchTrainMerge(cfg, n_branches=args.branches,
                           strategy=args.strategy,
                           merge_every=args.merge_every,
                           batch_size=args.batch, seq_len=args.seq,
                           use_deltas=args.deltas,
                           total_steps=args.rounds * args.merge_every,
                           device=args.device)

    base_eval = [btm.eval_loss(btm.base_params, t)
                 for t in range(args.branches)]
    print("base model per-task eval loss:",
          " ".join(f"{x:.3f}" for x in base_eval))

    for r in range(args.rounds):
        if r == 2 and args.kill >= 0:
            print(f"-- killing branch {args.kill}")
            btm.kill_branch(args.kill)
        if r == 2 and args.straggle >= 0:
            print(f"-- branch {args.straggle} straggles this round")
            btm.mark_straggler(args.straggle, rounds=1)
        if r == 3 and args.join:
            idx = btm.add_branch()
            print(f"-- branch {idx} joined elastically")
        rec = btm.train_round()
        losses = " ".join(f"b{i}:{loss:.3f}" for i, loss in
                          sorted(rec["losses"].items()))
        print(f"round {rec['round']:2d}  {losses}")

    merged = btm._resolved_params()
    merged_eval = [btm.eval_loss(merged, t) for t in range(args.branches)]
    print("merged model per-task eval loss:",
          " ".join(f"{x:.3f}" for x in merged_eval))
    wins = sum(m < b for m, b in zip(merged_eval, base_eval))
    print(f"merged model improves on {wins}/{args.branches} tasks "
          f"(CRDT-merged, coordinator-free)")


if __name__ == "__main__":
    main()

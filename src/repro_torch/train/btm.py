"""Branch-Train-Merge with CRDT aggregation (`repro.train.btm`), the
end-to-end integration of the paper's technique into the training loop.

k branches fine-tune the same base model on different synthetic tasks.
Every `merge_every` steps each ALIVE branch contributes its parameters
to its local CRDTMergeState; states gossip (all-pairs or epidemic, full
or delta); every branch independently resolves the identical merged
model and continues training from it. There is no coordinator:

  * node failure     — a dead branch's last contribution persists in the
                       OR-Set; the survivors keep converging;
  * stragglers       — resolve() runs over whatever is visible at the
                       deadline; a late add lands in the next round and
                       (being content-addressed) dedups if identical;
  * elastic scaling  — a joining branch syncs with one gossip exchange
                       and participates in the next round;
  * restart          — branch state + CRDT state checkpoint/restore
                       (repro_torch.checkpoint), resuming mid-round.

The port's train step updates a branch's state in place, so where the
reference shares an immutable buffer the port copies: each branch
starts from its own copy of the base state, a contribution (and a
straggler's pending one) is a copy of the branch's parameters, and a
branch takes the merged model by copying it into its own parameters (the
resolved tree stays as the engine cached it). A joining branch starts
from the merged parameters with zero moments at step 0 (the reference
draws fresh parameters for it and replaces them with the merged ones).
Each round empties the merge-output cache, as the reference's
`clear_cache()` does, but keeps the planner's digest memo, which
`clear_cache()` also drops: the memo is keyed by content id, so it
cannot change a merged byte, and keeping it spares re-digesting every
earlier round's contributions on the host (SHA-256 of each, every
round).
`params=` gives the base parameters (the chip smoke's seeded full-size
models); without it they are `Model.init(PRNGKey(seed))`, bitwise the
reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch import pytree
from repro_torch import random as prng
from repro_torch.api.replica import resolve_device
from repro_torch.api.spec import MergeSpec
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.engine import default_cache
from repro_torch.core.gossip import GossipNetwork, GossipNode
from repro_torch.data.synthetic import SyntheticTask
from repro_torch.models.model import Model
from repro_torch.train.step import init_train_state, make_train_step


def _clone(tree: Any) -> Any:
    return pytree.tree_map(lambda t: t.clone(), tree)


@dataclass
class Branch:
    index: int
    state: Dict
    task: SyntheticTask
    alive: bool = True
    straggler_rounds: int = 0      # contributes this many rounds late
    pending: Optional[Dict] = None


class BranchTrainMerge:
    def __init__(self, cfg: ModelConfig, n_branches: int = 4,
                 strategy: str = "weight_average", merge_every: int = 20,
                 batch_size: int = 8, seq_len: int = 64,
                 protocol: str = "all_pairs", use_deltas: bool = False,
                 seed: int = 0, total_steps: int = 1000, *,
                 device: Any = None, params: Any = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.strategy = strategy
        self.merge_every = merge_every
        self.batch_size = batch_size
        self.shape = ShapeSpec("btm", seq_len, batch_size, "train")
        self.protocol = protocol
        self.step_fn = make_train_step(self.model, total_steps)
        base_state = init_train_state(self.model, prng.PRNGKey(seed),
                                      params=params, device=self.device)
        self.base_params = base_state["params"]
        self.branches: List[Branch] = [
            Branch(index=i, state=_clone(base_state), task=self._task(i))
            for i in range(n_branches)]
        self.net = GossipNetwork(n_branches, seed=seed,
                                 use_deltas=use_deltas, device=self.device)
        self.round = 0
        self.history: List[Dict] = []

    # ------------------------------------------------------------- admin

    def _task(self, index: int) -> SyntheticTask:
        return SyntheticTask(self.cfg.vocab_size, self.shape.seq_len,
                             task_id=index)

    def kill_branch(self, index: int) -> None:
        self.branches[index].alive = False

    def add_branch(self) -> int:
        """Elastic join: the new branch starts from the current merged
        model."""
        index = len(self.branches)
        state = init_train_state(self.model,
                                 params=_clone(self._resolved_params()),
                                 device=self.device)
        self.branches.append(Branch(index=index, state=state,
                                    task=self._task(index)))
        node = GossipNode(f"node{index:03d}", self.device)
        node.state = node.state.merge(self.net.nodes[0].state)  # sync join
        self.net.nodes.append(node)
        return index

    def mark_straggler(self, index: int, rounds: int = 1) -> None:
        self.branches[index].straggler_rounds = rounds

    # ------------------------------------------------------------- train

    def _make_batch(self, br: Branch, step: int) -> Dict:
        return {"tokens": torch.as_tensor(
            br.task.batch(step, self.batch_size), device=self.device)}

    def train_round(self) -> Dict:
        """merge_every local steps per alive branch, then merge."""
        losses = {}
        for br in self.branches:
            if not br.alive:
                continue
            for s in range(self.merge_every):
                step = self.round * self.merge_every + s
                br.state, mets = self.step_fn(br.state,
                                              self._make_batch(br, step))
            losses[br.index] = float(mets["loss"])
        self._contribute_and_merge()
        self.round += 1
        rec = {"round": self.round, "losses": losses}
        self.history.append(rec)
        return rec

    def _contribute_and_merge(self) -> None:
        # contribute (stragglers defer to a later round)
        for br in self.branches:
            if not br.alive:
                continue
            if br.straggler_rounds > 0:
                br.straggler_rounds -= 1
                br.pending = _clone(br.state["params"])
                continue
            if br.pending is not None:      # late contribution lands now
                self.net.nodes[br.index].contribute(br.pending)
                br.pending = None
            self.net.nodes[br.index].contribute(_clone(br.state["params"]))
        # gossip to convergence
        if self.protocol == "all_pairs":
            self.net.all_pairs_round()
        else:
            self.net.run_epidemic(fanout=3)
        assert self.net.converged(), "gossip did not converge"
        # every alive branch independently resolves the SAME model; the
        # round's merge outputs start empty (the planner's digest memo
        # stays: it is keyed by content id)
        default_cache().clear()
        for br in self.branches:
            if not br.alive:
                continue
            out = self.net.nodes[br.index].resolve(
                MergeSpec(self.strategy), base=self.base_params)
            with torch.no_grad():
                for p, m in zip(pytree.leaves(br.state["params"]),
                                pytree.leaves(out)):
                    p.copy_(m.to(p.dtype))

    def _resolved_params(self):
        alive = next(b for b in self.branches if b.alive)
        return self.net.nodes[alive.index].resolve(
            MergeSpec(self.strategy), base=self.base_params)

    # -------------------------------------------------------------- eval

    @torch.no_grad()
    def eval_loss(self, params, task_id: int, batches: int = 2) -> float:
        task = SyntheticTask(self.cfg.vocab_size, self.shape.seq_len,
                             task_id=task_id)
        tot = 0.0
        for i in range(batches):
            batch = {"tokens": torch.as_tensor(
                task.batch(10_000 + i, self.batch_size),
                device=self.device)}
            loss, _ = self.model.loss(params, batch)
            tot += float(loss)
        return tot / batches

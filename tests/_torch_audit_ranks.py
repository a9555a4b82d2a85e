"""Rank functions for the audit's real-stack tests: spawned gloo ranks
import this module by name, so the red-team hook lives at module level."""
from repro_torch.launch import audit as LA

LEGS = ["shard_map/coda/fp32/blocking", "shard_map/coda/fp32/overlap",
        "shard_map/coda/int8/blocking/masked"]


def smuggle(exe, state):
    """A collective inside the local steps: one all_reduce of a dual."""
    exe.wire.all_reduce(state["duals"]["a"].clone())


def rank_legs(rank: int, n_ranks: int, smuggled: bool) -> list:
    return LA.sharded_legs_on_rank(rank, LEGS, n_ranks, True, "cpu",
                                   local_steps_hook=smuggle if smuggled else None)

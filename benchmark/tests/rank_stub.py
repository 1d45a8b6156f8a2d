"""A runner for ``harness/ranks.py``'s test: each rank meets the others in
one collective; with ``load_jax`` the ranks after rank 0 then put a module
named ``jax`` into ``sys.modules``."""
import sys
import types

import torch
import torch.distributed as tdist


def run_rank(load_jax: bool, device=None) -> dict:
    t = torch.ones(1)
    tdist.all_reduce(t)
    if load_jax and tdist.get_rank() > 0:
        sys.modules["jax"] = types.ModuleType("jax")
    return {"world": int(t.item())}

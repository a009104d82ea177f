"""Eval loop with exact aggregation, on one device or sharded over the
data-parallel ranks (counterpart of gator_tpu/train/evaluate.py:25
`run_eval`).

The reference accumulates running error sums over batches (reference:
lib/core/base.py:224-230); a mean of batch means would over-weight a ragged
last batch. Every eval step returns per-sample errors; their sums stay on
the device and are read once per key at the end, so the result is exactly
the per-sample mean. With a `world` of several ranks every rank sees the
whole global batch, pads it to a multiple of the world size (repeating the
last sample), and evaluates its rows; the pad tail is dropped before
summing, the sums and the count are all-reduced on the device at the end,
and the collected outputs are all-gathered back into row order. The
result is the exact per-sample mean on any world size.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from ..parallel import (all_gather_rows, all_reduce_sum_, local_rows,
                        pad_to_multiple)

# per-sample error keys an eval step may emit
ERROR_KEYS = ("joint_err", "surface_err")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_eval(eval_step, model, pipeline,
             collect_out: Sequence[str] = (),
             collect_batch: Sequence[str] = (), world=None) -> Dict[str, Any]:
    """Run `eval_step(model, batch)` over a batch iterable.

    collect_out / collect_batch: per-sample output / input keys to gather
    on the host, concatenated over batches. Returns {err_key: exact mean}
    for every ERROR_KEYS the step emits, 'count', and the gathered
    arrays. world: the data-parallel ranks the batches are sharded over
    (module docstring); every rank gets the same result."""
    dup = set(collect_out) & set(collect_batch)
    if dup:
        raise ValueError(
            f"collect_out and collect_batch overlap on {sorted(dup)}: "
            "the gathered results would interleave outputs and inputs")
    sharded = world is not None and world.grouped
    sums: Dict[str, torch.Tensor] = {}
    count = 0
    gathered: Dict[str, list] = {k: [] for k in
                                 tuple(collect_out) + tuple(collect_batch)}
    for batch in pipeline:
        n = len(batch["pose2d"])
        real = n
        if sharded:
            padded, _ = pad_to_multiple(batch, world.size)
            local = local_rows(padded, world)
            b = len(local["pose2d"])
            real = min(max(n - world.rank * b, 0), b)
            out = eval_step(model, local)
        else:
            out = eval_step(model, batch)
        for k in ERROR_KEYS:
            if k in out:
                # summed on the device: a host read per batch would wait
                # for the card every batch
                part = out[k][:real].double().sum()
                sums[k] = sums[k] + part if k in sums else part
        for k in collect_out:
            gathered[k].append(_host(all_gather_rows(out[k], world))[:n])
        for k in collect_batch:
            gathered[k].append(_host(batch[k]))
        count += real

    if sharded:
        keys = list(sums)
        total = all_reduce_sum_(torch.stack(
            [sums[k].to(world.device) for k in keys]
            + [torch.tensor(float(count), dtype=torch.float64,
                            device=world.device)]), world)
        sums = dict(zip(keys, total[:-1].unbind()))
        count = int(total[-1])
    result: Dict[str, Any] = {"count": count}
    for k, v in sums.items():
        result[k] = float(v) / max(count, 1)   # one read per key, at the end
    for k, chunks in gathered.items():
        if chunks:
            result[k] = np.concatenate(chunks)
    return result

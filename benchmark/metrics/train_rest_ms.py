"""Device ms a training step outside K4, K5 and NCCL: the step's plain
torch (the in-step input assembly with its noise sampler and GT
synthesis, the embeds, the MDR tokens and head, the losses, their
backward, Adam)."""
from benchmark.core import trace

KERNELS = (r"\b(gat_block_(fwd|bwd|wgrad)|reduce_partials_kernel|"
           r"lbf_(rows_fwd|sa_fwd|sa_bwd_dq|sa_bwd_dkv|rows_bwd|wgrad|"
           r"joints_bwd|reduce)_kernel)\b|nccl")


def read(layer: dict):
    tr = layer.get("trace")
    if tr is None or not tr.device:
        return None
    return 1e3 * trace.seconds_outside(tr, KERNELS) / layer["traced_steps"]

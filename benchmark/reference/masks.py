"""Frozen copy of the port's dropout-mask hash (gator_tpu_torch/nn/
dropout_masks.py): the masks of the training kernels (K4, K5), drawn from
one counter-based hash that the kernels and this copy share bit for bit.

A mask element is keyed by (seed, unit, sample, mask-id, element index):
`unit` is the LBF layer (K4) or `GAT_UNIT_BASE + block` (K5), `sample` the
sample's index in the global batch (`sample0` + its index in the kernel's
batch: a data-parallel rank that holds rows [r*b, (r+1)*b) of the global
batch passes sample0 = r*b and draws those rows' masks), `mask-id` one of
the ids below, and the element
index the row-major offset inside that sample's mask. Keying per sample (not
per tile, as the TPU kernels seed their PRNG per grid program) lets the
forward and backward kernels tile differently and still draw the same mask.

Bits: murmur3's 32-bit finalizer, in uint32 arithmetic on the card and
emulated here in int64 (products split into 16-bit halves, so nothing
overflows). The keep rule and the mask-id layout are the TPU kernels'
(gator_tpu/nn/pallas_mdr_train.py:56-63,158-166,
gator_tpu/nn/pallas_gat_train.py:60-62): keep when
`(bits >> 8) < round((1 - rate) * 2**24)`, then scale by `1 / (1 - rate)`.
The masks cannot equal the TPU's (its bits come from the core's PRNG).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# mask ids; the two attention families budget 8 heads each
M_ATTN0 = 0                    # + head
M_PROJ, M_DP1, M_MLP1, M_MLP2, M_DP2 = 8, 9, 10, 11, 12
M_SELF0 = 16                   # + head (K4's self-attention)
M_OUT = 24                     # K4's self-attention residual
MID_STRIDE = 32

GAT_UNIT_BASE = 256            # K5 block b draws from unit 256 + b

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h in [0, 2**32) and a 32-bit constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fmix_int(h: int) -> int:
    return int(fmix32(torch.tensor(h & _M32, dtype=torch.int64)))


def stream_keys(seed: int, unit: int, samples: torch.Tensor,
                mid: int) -> torch.Tensor:
    """One uint32 stream key (in int64) per sample index."""
    k = _fmix_int(seed ^ _GOLDEN)
    k = _fmix_int(k ^ ((unit * 0x85EBCA77 + 0x165667B1) & _M32))
    return fmix32(k ^ ((samples.to(torch.int64) * MID_STRIDE + mid) & _M32))


def threshold(rate: float) -> int:
    """The keep threshold on the 24-bit draw (the TPU kernels' rule)."""
    return int(round((1.0 - rate) * (1 << 24)))


def keep_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def mask_bits(seed: int, unit: int, mid: int, batch: int, numel: int,
              device=None, sample0: int = 0) -> torch.Tensor:
    """[batch, numel] uint32 draws (in int64) of samples sample0 ..
    sample0 + batch - 1."""
    keys = stream_keys(seed, unit, torch.arange(sample0, sample0 + batch,
                                                device=device), mid)
    idx = _mul32(torch.arange(numel, dtype=torch.int64, device=device),
                 _GOLDEN)
    return fmix32(keys[:, None] ^ idx[None, :])


def keep_mask(seed: int, unit: int, mid: int, rate: float, batch: int,
              shape: Sequence[int], device=None,
              sample0: int = 0) -> Optional[torch.Tensor]:
    """Scaled keep mask [batch, *shape] (f32 values in {0, 1/(1-rate)}) of
    samples sample0 .. sample0 + batch - 1, or None at rate 0 (no draw, as
    in the kernels)."""
    if rate == 0.0:
        return None
    numel = 1
    for n in shape:
        numel *= int(n)
    bits = mask_bits(seed, unit, mid, batch, numel, device, sample0)
    keep = (bits >> 8) < threshold(rate)
    return (keep.to(torch.float32) * keep_scale(rate)).reshape(batch,
                                                               *shape)


def step_seed(seed: int, step: int) -> int:
    """A kernel seed in [0, 2**31) for one training step (the JAX steps fold
    the step counter into their PRNG key the same way)."""
    return _fmix_int(_fmix_int(seed ^ 0x7F4A7C15) ^ (step & _M32)) \
        & 0x7FFFFFFF

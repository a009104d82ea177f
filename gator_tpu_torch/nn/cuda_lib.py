"""Build and load the hand-written CUDA kernels, and pack their weights.

Each `csrc/<name>.cu` is compiled on first use by `nvcc` into
`build/kernels/lib<name>.so` at the root of the checkout (listed in
.gitignore) and loaded with ctypes; the sources have a plain C interface,
so a build takes seconds. A library is rebuilt when a source under `csrc/`
is newer than it. Nothing here runs at import time: the CPU-only test
environment imports every module and has no nvcc.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import os.path as osp
import shutil
import subprocess
import time
from typing import Dict, List, Sequence, Tuple

import torch

from ..profiling import span

CSRC = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "csrc")
BUILD_DIR = osp.join(osp.dirname(osp.dirname(CSRC)), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; filled on first use
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = osp.join(home, "bin", "nvcc")
    if not osp.isfile(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA "
                           "kernels are built on the machine with the card")
    return path


def build(name: str) -> Tuple[str, float]:
    """Compile csrc/<name>.cu unless the library is up to date.
    -> (library path, seconds spent compiling; 0.0 when up to date)."""
    src = osp.join(CSRC, f"{name}.cu")
    lib = osp.join(BUILD_DIR, f"lib{name}.so")
    deps = [osp.join(CSRC, f) for f in os.listdir(CSRC)
            if f.endswith((".cu", ".cuh"))]
    if osp.isfile(lib) and osp.getmtime(lib) >= max(map(osp.getmtime, deps)):
        return lib, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    with open(osp.join(BUILD_DIR, f"lib{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib, seconds


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>.so, declaring each C function's
    argument types; every function returns a cudaError_t as int. The first
    load of a library is the set-up span setup.kernels."""
    if name not in _LOADED:
        with span("setup.kernels", always=True):
            lib = ctypes.CDLL(build(name)[0])
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LOADED[name] = lib
    return _LOADED[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_dtype(dtype: torch.dtype) -> int:
    """The C interface's dtype code: 0 = float32, 1 = bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]


@dataclasses.dataclass
class Packed:
    """Per-layer weights packed into one [L, stride] tensor for a kernel.

    `layers[l][field]` are views into `flat`, so the plain version reads
    exactly the values (rounded to the kernel's dtype) that the kernel
    reads. `offsets` gives each field's element offset within a layer, in
    the field order of the kernel's `enum Field`."""

    flat: torch.Tensor
    offsets: torch.Tensor
    layers: List[Dict[str, torch.Tensor]]

    @property
    def dtype(self) -> torch.dtype:
        return self.flat.dtype


def field_offsets(numels: Sequence[int]) -> Tuple[List[int], int]:
    """-> (element offset of each field, stride of the packed fields):
    every field starts on an 8-element boundary so the kernels can load
    16-byte vectors."""
    offsets, pos = [], 0
    for n in numels:
        offsets.append(pos)
        pos += -(-int(n) // 8) * 8
    return offsets, pos


def pack_fields(tensors: Sequence[torch.Tensor], offsets: Sequence[int],
                stride: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """Copy `tensors` (detached) into one flat [stride] tensor at
    `offsets`, zero between the fields, in one concatenation (a handful of
    launches, not two per field). The training Functions pack inside their
    forward and return the parameters' gradients themselves."""
    device = tensors[0].device if device is None else device
    zeros = torch.zeros(8, dtype=tensors[0].dtype, device=device)
    pieces, pos = [], 0
    for t, off in zip(tensors, offsets):
        if off > pos:
            pieces.append(zeros[:off - pos])
        pieces.append(t.detach().reshape(-1).to(device=device))
        pos = off + t.numel()
    if stride > pos:
        pieces.append(zeros[:stride - pos])
    return torch.cat(pieces).to(dtype)


def _views(flat: torch.Tensor, shapes: Dict[str, torch.Size],
           offsets: Sequence[int]) -> List[Dict[str, torch.Tensor]]:
    """Each layer's fields as views into `flat` [L, stride]."""
    return [{n: flat[li, off:off + shape.numel()].view(shape)
             for (n, shape), off in zip(shapes.items(), offsets)}
            for li in range(flat.shape[0])]


def pack(layers: List[Dict[str, torch.Tensor]], fields: Sequence[str],
         dtype: torch.dtype, device) -> Packed:
    """Pack each layer's tensors (all the same shapes across layers) in
    `fields` order, as `pack_fields` lays them out."""
    offsets, stride = field_offsets(layers[0][n].numel() for n in fields)
    flat = torch.stack([pack_fields([layer[n] for n in fields], offsets,
                                    stride, dtype, device)
                        for layer in layers])
    shapes = {n: layers[0][n].shape for n in fields}
    return Packed(flat, torch.tensor(offsets, dtype=torch.int32,
                                     device=device),
                  _views(flat, shapes, offsets))


def stack(packs: Sequence[Packed]) -> Packed:
    """Packed weight sets of the same fields and shapes, layer after layer,
    as one."""
    flat = torch.cat([p.flat for p in packs])
    shapes = {n: t.shape for n, t in packs[0].layers[0].items()}
    return Packed(flat, packs[0].offsets,
                  _views(flat, shapes, packs[0].offsets.tolist()))

"""gator_tpu_torch — GATOR (pose -> mesh) in PyTorch with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a), and MotionBERT's mesh model (2D
skeleton clips -> meshes, `models.motionbert`) on the same serving path:
the serving path, the train steps of
both stages, the evaluation path (SMPL body model, GT synthesis, metrics,
eval CLI), the demo, data parallelism over one process per card
(`parallel`), and the kernel tools (per-stage serving profile, LBF-layer
ablations).

A port of the JAX package `gator_tpu`, which stays the reference: the
module layout and names follow it. This package imports torch and never
jax or gator_tpu; its CUDA kernels (csrc/) are built with nvcc on first
use, so importing it needs neither a GPU nor a compiler.
"""
from . import (assets, bodymodel, config, convert, data, losses, metrics,
               models, nn, ops, parallel, profiling, serving, smoothing,
               train, vis)
from .models import GATOR, GatorSpec, build_gator
from .serving import make_serving_fn, make_sharded_serving_fn

__all__ = ["GATOR", "GatorSpec", "assets", "bodymodel", "build_gator",
           "config", "convert", "data", "losses", "make_serving_fn",
           "make_sharded_serving_fn", "metrics", "models", "nn", "ops",
           "parallel", "profiling", "serving", "smoothing", "train", "vis"]

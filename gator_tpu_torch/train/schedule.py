"""Optimizers and LR schedules (counterpart of gator_tpu/train/schedule.py;
reference: lib/funcs_utils.py:76-107): Adam, SGD and RMSprop built with the
reference's hyperparameters in optax's arithmetic, the step-indexed
`multistep_lr` (MultiStepLR), the host-side `ReduceLROnPlateau`
controller, and `set_learning_rate`, which both schedules act through.

A step schedule reaches the optimizer through the train state
(`TrainState.lr_schedule`): update number s runs at lr(s), as
optax.piecewise_constant_schedule inside optax.adam gives it. The plateau
controller's lr is set once an epoch by the caller (cli/train.py), as the
JAX package rewrites its injected hyperparameter.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import torch


def multistep_lr(base_lr: float, milestones_epochs: Sequence[int],
                 factor: float, steps_per_epoch: int) -> Callable[[int], float]:
    """-> lr(step). torch MultiStepLR as the reference steps it once per
    epoch: epochs 1..m train at the old lr and the drop takes effect from
    epoch m+1, i.e. from global step m * steps_per_epoch (the JAX package's
    piecewise-constant schedule, gator_tpu/train/schedule.py:15-22)."""
    bounds = sorted(m * steps_per_epoch for m in milestones_epochs)

    def lr(step: int) -> float:
        out = float(base_lr)
        for b in bounds:
            if step >= b:
                out *= factor
        return out

    return lr


class Adam(torch.optim.Optimizer):
    """Adam in optax.adam's arithmetic and order (bias corrections in f32,
    then m_hat / (sqrt(v_hat) + eps), then -lr * update added to the
    parameter), so that a step agrees with optax's to the last bit where
    torch.optim.Adam differs by an ulp or two. Each step is a handful of
    multi-tensor (`torch._foreach_*`) launches over all the parameters;
    every parameter of a group is stepped together."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
            t = self.state[params[0]]["step"]
            grads = [p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            # the f32 bias corrections, as exact Python floats
            one = torch.ones((), dtype=torch.float32)
            c1 = float(1 - (one * b1) ** t)
            c2 = float(1 - (one * b2) ** t)
            den = torch._foreach_div(nus, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mus, c1)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)


class RMSprop(torch.optim.Optimizer):
    """RMSprop in optax.rmsprop's arithmetic and defaults (decay 0.9, eps
    1e-8, initial scale 0, no centring, no momentum): nu = (1 - decay) g^2
    + decay nu, then -lr * g * rsqrt(nu + eps), eps inside the square
    root, where torch.optim.RMSprop adds it outside. Multi-tensor, as
    `Adam`."""
    DECAY, EPS = 0.9, 1e-8

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        d = self.DECAY
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
            grads = [p.grad for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(nus, d)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - d))
            scale = torch._foreach_add(nus, self.EPS)
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_mul_(scale, -group["lr"])
            torch._foreach_add_(params, scale)


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   lr: float, momentum: float = 0.9
                   ) -> torch.optim.Optimizer:
    """The optimizer by reference name, as the JAX package builds it with
    optax (gator_tpu/train/schedule.py:25-36): adam (b1=0.9, b2=0.999,
    eps=1e-8, `Adam`), sgd (nesterov, `momentum`; torch.optim.SGD's
    update is optax.sgd's), rmsprop (optax.rmsprop's defaults: decay 0.9,
    eps 1e-8 inside the square root, `RMSprop`)."""
    if name == "adam":
        return Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               nesterov=True)
    if name == "rmsprop":
        return RMSprop(params, lr=lr)
    raise ValueError(f"unknown optimizer {name!r}")


@dataclasses.dataclass(frozen=True)
class OptimizerFactory:
    """What `cli.common.Session.make_optimizer` returns, and what
    `Session.make_train_step` takes: `factory(params)` builds the named
    optimizer at `lr`, and `schedule` (lr(step), or None) becomes the
    train state's `lr_schedule`."""
    name: str
    lr: float
    schedule: Optional[Callable[[int], float]] = None

    def __call__(self, params: Iterable[torch.nn.Parameter]
                 ) -> torch.optim.Optimizer:
        return make_optimizer(self.name, params, self.lr)


def set_learning_rate(state, lr: float):
    """Set the lr of every param group of `state.optimizer` (counterpart
    of gator_tpu/train/schedule.py:199 `set_learning_rate`, which rewrites
    the injected learning_rate leaf); -> the state."""
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


class ReduceLROnPlateau:
    """Host-side torch ReduceLROnPlateau(mode='min', threshold=1e-4 rel,
    cooldown=0) controller (reference: lib/funcs_utils.py:106-107 with
    patience=10, min_lr=1e-5). Call `update(metric)` once per epoch; it
    returns the lr to use next."""

    def __init__(self, base_lr: float, factor: float, patience: int = 10,
                 min_lr: float = 1e-5, threshold: float = 1e-4):
        self.lr = float(base_lr)
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_lr = float(min_lr)
        self.threshold = float(threshold)
        self.best = float("inf")
        self.num_bad_epochs = 0

    def update(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = float(metric)
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad_epochs = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best,
                "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d):
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad_epochs = int(d["num_bad_epochs"])
